"""chip_smoke.py: every phase at a tiny ring on the CPU, the exit without a
GPU, and the compile-cache helper."""

import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mxx_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


@pytest.mark.parametrize("phase", list(chip_smoke.PHASES))
def test_phase_at_tiny_ring(phase):
    cfg = chip_smoke.TINY[phase]
    rings = cfg.get("shapes") or [cfg["ring"]]
    assert all(r[0] <= 256 for r in rings)
    assert "[" in chip_smoke.PHASES[phase](cfg)


def test_main_without_gpu_exits_nonzero(monkeypatch, tmp_path, capsys):
    # a set cache dir makes the helper a no-op, so the test process's own
    # compile cache setting stays as it was
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code == 1
    captured = capsys.readouterr()
    assert "no GPU found" in captured.err
    assert captured.out == ""


@pytest.mark.parametrize("env_set", [False, True], ids=["unset", "set"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = enable_compile_cache()
        if env_set:
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
