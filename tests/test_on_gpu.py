"""Card-only checks: the exact integer kernels compiled for the GPU give the
CPU backend's result on every output, where chip_smoke.py samples entries.

On the card: `JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`
(`chip_smoke.py` runs them in its gpu_tests phase). Elsewhere the `gpu`
fixture skips them.
"""

import functools

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
import jax

from mxx_tpu.ops.decompose import digit_decompose
from mxx_tpu.ops.zq_matmul import zq_matmul
from mxx_tpu.ring.ntt import ntt_fwd, ntt_inv
from mxx_tpu.ring.params import RingParams
from mxx_tpu.sampler import chacha


def _residues(params, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64).astype(np.uint32)
                     for q in params.moduli])


def _on(device, fn, *args):
    """fn(*args) compiled for `device`, with every operand committed there."""
    return np.asarray(jax.jit(fn)(*(jax.device_put(np.asarray(a), device) for a in args)))


def _same_on_both(gpu, fn, *args):
    want = _on(jax.devices("cpu")[0], fn, *args)
    got = _on(gpu, fn, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    mismatch = np.flatnonzero(got != want)
    assert mismatch.size == 0, f"{mismatch.size} of {got.size} outputs differ"
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("ring", [(1 << 13, 8, 28, 14, 16), (1 << 16, 4, 28, 14, 2)],
                         ids=["n8192_L8", "n65536_L4"])
def test_ntt_chain_equals_cpu_backend(gpu, ring):
    n, L, bits, base, B = ring
    params = RingParams.new(n, L, bits, base)
    jt = params.jt
    x = _residues(params, (B, n), seed=n)
    y = _same_on_both(gpu, ntt_fwd, x, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    back = _same_on_both(gpu, ntt_inv, y, jt.psi_inv_rev_mont, jt.n_inv_mont,
                         jt.moduli, jt.qinv_neg)
    assert np.array_equal(back, x)


@pytest.mark.gpu
def test_zq_matmul_equals_cpu_backend(gpu):
    params = RingParams.new(1 << 12, 4, 24, 12)
    jt = params.jt
    a = _residues(params, (2, 30, params.n), seed=1)
    b = _residues(params, (30, 8, params.n), seed=2)
    _same_on_both(gpu, zq_matmul, a, b, jt.moduli, jt.qinv_neg,
                  jt.combine_pows_mont, jt.sign_corr_pows)


@pytest.mark.gpu
def test_digit_decompose_equals_cpu_backend(gpu):
    params = RingParams.new(1 << 13, 8, 28, 14)
    jt = params.jt
    x = _residues(params, (2, 4, params.n), seed=3)
    fn = functools.partial(digit_decompose, base_bits=params.base_bits,
                           dpt=params.digits_per_tower, towers=params.crt_depth)
    _same_on_both(gpu, fn, x, jt.moduli, jt.digit_masks)


@pytest.mark.gpu
def test_chacha_keystream_equals_cpu_backend(gpu):
    key = chacha.key_from_bytes(bytes(range(32)))
    _same_on_both(gpu, functools.partial(chacha.random_bits, shape=(64, 4096)), key)
