"""Smoke run of the library's main path on NVIDIA GPUs.

Runs every phase in one process on jax.devices()[0], at the widths the
reference and ROADMAP.md name, and checks each phase against a plain
reference (tests/reference_impl.py or Python-int arithmetic). A failed check
raises; nothing is caught.

  device        the first JAX device is a GPU; there is no CPU fallback
  ntt           forward/inverse NTT chain (ring/ntt.py) at n=2^13, L=8, B=512
                and at the production ring n=2^16, L=53, B=8: exact round
                trip, forward outputs against Python-int evaluation at
                psi^(2 bitrev(i) + 1), one negacyclic product through
                pointwise_mul against the schoolbook reference
  zq_matmul     PolyMatrix @ in EVAL form, 1x30 . 30x120 at n=2^14, L=15,
                24-bit limbs (the reference's bench_matrix_mul): sampled
                entries against Python-int dot products mod q
  gsw_ext_prod  C @ G^-1(c) at n=2^13, L=8, base 2^14, B=64: G G^-1(c) == c
                and sampled product entries
  preimage      TrapdoorSampler.preimage, d=1: 50 columns at n=2^14, L=10,
                24-bit, base 2^12 (the reference's bench_preimage) and 8
                columns at n=2^14, L=53, 28-bit, base 2^14: A x == U exactly;
                the ChaCha20 block against RFC 8439; Gaussian moments
  lwe_chain     the LWE mod-p chain of scripts/realistic_scale_run.py at
                n=2^13, L=8, base 2^14, decoded against the plaintext oracle
                (its params_tables reads the ring the ntt phase built; the
                ntt phase's tables_s is that set-up cost)
  gpu_tests     the `gpu`-marked tests (tests/test_on_gpu.py: every output
                of the NTT chain, Z_q matmul, G^-1 and ChaCha against the
                CPU backend), run by pytest in this process

`--four-cards` runs only the sharded offline planes, on four GPUs at n=2^13,
L=8: preimage_batched_sharded over 64 columns, one LWE LUT K_high plane, and
crt_switch_sharded, each against its single-device result.

Each phase prints one line: its checks, compile and wall seconds, the
process's peak device memory so far, and the card. The line before the last
is nvidia-smi's `name, power.limit`; the last line is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

    python chip_smoke.py                 # one GPU
    python chip_smoke.py --four-cards    # four GPUs
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import mxx_tpu  # noqa: E402,F401  (enables x64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from mxx_tpu.lookup.modp_chain import run_lwe_modp_chain  # noqa: E402
from mxx_tpu.matrix import PolyMatrix  # noqa: E402
from mxx_tpu.parallel.crt_collective import crt_switch_sharded  # noqa: E402
from mxx_tpu.parallel.mesh import COL_AXIS, LIMB_AXIS, make_mesh  # noqa: E402
from mxx_tpu.ring.ntt import ntt_fwd, ntt_inv, pointwise_mul  # noqa: E402
from mxx_tpu.ring.params import RingParams  # noqa: E402
from mxx_tpu.ring.poly import COEFF, EVAL  # noqa: E402
from mxx_tpu.sampler import (  # noqa: E402
    FinRingDist, GaussDist, TrapdoorSampler, UniformSampler, chacha,
)
from mxx_tpu.utils import numth  # noqa: E402
from mxx_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from mxx_tpu.utils.device import nvidia_smi_cards, require_gpu  # noqa: E402
from reference_impl import negacyclic_mul, poly_eval  # noqa: E402

SIGMA = 4.578

# widths of the reference and ROADMAP.md; TINY keeps every shape's structure
# at n <= 256 (L <= 3, except the four-card limb split) for the CPU tests
FULL = {
    "ntt": {"shapes": [(1 << 13, 8, 28, 14, 512), (1 << 16, 53, 28, 14, 8)],
            "samples": 64, "mul_nonzeros": 64, "iters": 10},
    "zq_matmul": {"ring": (1 << 14, 15, 24, 12), "rkc": (1, 30, 120), "samples": 256},
    "gsw_ext_prod": {"ring": (1 << 13, 8, 28, 14), "batch": 64, "samples": 256},
    "preimage": {"shapes": [(1 << 14, 10, 24, 12, 50), (1 << 14, 53, 28, 14, 8)],
                 "gauss": (4, 4)},
    "lwe_chain": {"ring": (1 << 13, 8, 28, 14)},
    "four_cards": {"ring": (1 << 13, 8, 28, 14), "cols": 64, "samples": 256},
}
TINY = {
    "ntt": {"shapes": [(64, 2, 20, 5, 4), (256, 3, 28, 14, 2)],
            "samples": 16, "mul_nonzeros": 8, "iters": 1},
    "zq_matmul": {"ring": (16, 2, 24, 12), "rkc": (1, 3, 5), "samples": 16},
    "gsw_ext_prod": {"ring": (16, 2, 28, 14), "batch": 4, "samples": 16},
    "preimage": {"shapes": [(16, 2, 20, 5, 3), (32, 3, 28, 14, 2)],
                 "gauss": (16, 16)},
    "lwe_chain": {"ring": (16, 3, 28, 7)},
    "four_cards": {"ring": (16, 4, 28, 7), "cols": 8, "samples": 16},
}
ONE_CARD_PHASES = ("ntt", "zq_matmul", "gsw_ext_prod", "preimage", "lwe_chain")

_COMPILE_S = [0.0]


def _on_duration(event: str, secs: float, **_):
    # lowering and XLA compilation; tracing events nest, so they are left out
    if event in ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                 "/jax/core/compile/backend_compile_duration"):
        _COMPILE_S[0] += secs


jax.monitoring.register_event_duration_secs_listener(_on_duration)


def _check(ok, what: str):
    if not ok:
        raise AssertionError(f"check failed: {what}")


def _residues(params: RingParams, shape: tuple, seed: int):
    """uint32[L, *shape, n] uniform residues per limb, drawn on the device."""
    q = jnp.asarray(params.np_moduli).reshape((-1,) + (1,) * (len(shape) + 1))
    bits = jax.random.bits(jax.random.key(seed),
                           (params.crt_depth, *shape, params.n), jnp.uint32)
    return bits % q


def _steady_s(fn, iters: int = 1) -> float:
    """Mean seconds per call of an already compiled `fn`."""
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _sampled_dots(rng, a, b, c, moduli, samples: int) -> int:
    """Check c[l, i, j, s] == sum_m a[l, i, m, s] * b[l, m, j, s] mod q_l at
    sampled (limb, row, col, slot) in Python ints; returns the count."""
    L, r, _, n = a.shape
    cols = b.shape[2]
    ls, is_, js, ss = (rng.integers(0, m, samples) for m in (L, r, cols, n))
    av = np.asarray(a[ls, is_, :, ss])
    bv = np.asarray(b[ls, :, js, ss])
    cv = np.asarray(c[ls, is_, js, ss])
    for t in range(samples):
        q = moduli[ls[t]]
        want = sum(int(x) * int(y) for x, y in zip(av[t], bv[t])) % q
        _check(int(cv[t]) == want, f"entry {(ls[t], is_[t], js[t], ss[t])}")
    return samples


def phase_ntt(cfg) -> str:
    rng = np.random.default_rng(0)
    out = []
    for n, L, bits, base, B in cfg["shapes"]:
        # host twiddle/CRT tables and their device copies, set-up cost
        t0 = time.perf_counter()
        params = RingParams.new(n, L, bits, base)
        jt = params.jt
        jax.block_until_ready((jt.psi_rev_mont, jt.psi_inv_rev_mont, jt.n_inv_mont))
        tables_s = time.perf_counter() - t0
        x = _residues(params, (B,), seed=n + L)

        def fwd(v=x):
            return ntt_fwd(v, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)

        y = fwd()

        def inv(v=y):
            return ntt_inv(v, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg)

        _check(bool(jnp.array_equal(inv(), x)), f"round trip n={n} L={L}")
        s = cfg["samples"]
        ts, bs, slots = (rng.integers(0, m, s) for m in (L, B, n))
        rows = np.asarray(x[ts, bs])
        got = np.asarray(y[ts, bs, slots])
        for k in range(s):
            q = params.moduli[ts[k]]
            psi = numth.find_primitive_2n_root(q, n)
            _check(pow(psi, n, q) == q - 1, "psi is a primitive 2n-th root")
            w = pow(psi, 2 * numth.bit_reverse(int(slots[k]), params.log_n) + 1, q)
            _check(int(got[k]) == poly_eval(rows[k].tolist(), w, q),
                   f"NTT slot {slots[k]} of limb {ts[k]}, n={n}")
        fwd_s = _steady_s(fwd, cfg["iters"])
        inv_s = _steady_s(inv, cfg["iters"])
        out.append(f"[n={n} L={L} B={B} tables_s={tables_s:.3f} "
                   f"roundtrip=exact evals={s}/{s} fwd_limb_ntts_per_s={L * B / fwd_s:.1f} "
                   f"inv_limb_ntts_per_s={L * B / inv_s:.1f}]")

    # one negacyclic product at the first shape: sparse a (the schoolbook
    # reference skips zero terms), dense b, compared on limb 0
    n, L, bits, base, _ = cfg["shapes"][0]
    params = RingParams.new(n, L, bits, base)
    jt = params.jt
    a = np.zeros((L, n), dtype=np.uint32)
    pos = rng.choice(n, cfg["mul_nonzeros"], replace=False)
    for t, q in enumerate(params.moduli):
        a[t, pos] = rng.integers(1, q, pos.size)
    b = _residues(params, (), seed=7)
    fa = ntt_fwd(jnp.asarray(a), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    fb = ntt_fwd(b, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    fc = pointwise_mul(fa, fb, jt.moduli, jt.qinv_neg, jt.r2)
    c = np.asarray(ntt_inv(fc, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg))
    q0 = params.moduli[0]
    want = negacyclic_mul(a[0].tolist(), np.asarray(b[0]).tolist(), q0)
    _check(c[0].tolist() == want, f"negacyclic product n={n}")
    out.append(f"[negacyclic_mul n={n} limb=0 exact]")
    return " ".join(out)


def phase_zq_matmul(cfg) -> str:
    n, L, bits, base = cfg["ring"]
    r, k, c = cfg["rkc"]
    params = RingParams.new(n, L, bits, base)
    a = PolyMatrix(_residues(params, (r, k), seed=1), EVAL, params)
    b = PolyMatrix(_residues(params, (k, c), seed=2), EVAL, params)
    prod = a @ b
    steady = _steady_s(lambda: (a @ b).data)
    s = _sampled_dots(np.random.default_rng(1), a.data, b.data, prod.data,
                      params.moduli, cfg["samples"])
    return (f"[{r}x{k} . {k}x{c} n={n} L={L} bits={bits} exact={s}/{s} "
            f"steady_s={steady:.6f}]")


def phase_gsw_ext_prod(cfg) -> str:
    n, L, bits, base = cfg["ring"]
    B = cfg["batch"]
    params = RingParams.new(n, L, bits, base)
    k = params.modulus_digits
    us = UniformSampler(seed=4)
    c_mat = us.sample_uniform(params, 2, 2 * k, FinRingDist()).to_eval()
    cts = us.sample_uniform(params, 2, B, FinRingDist())
    dec = cts.decompose()
    _check(PolyMatrix.gadget_matrix(params, 2) @ dec == cts, "G G^-1(c) == c")
    prod = c_mat @ dec
    steady = _steady_s(lambda: (c_mat @ cts.decompose()).data)
    s = _sampled_dots(np.random.default_rng(2), c_mat.data, dec.to_eval().data,
                      prod.data, params.moduli, cfg["samples"])
    return (f"[2x{2 * k} . G^-1(2x{B}) n={n} L={L} base=2^{base} "
            f"gadget=exact exact={s}/{s} ext_prods_per_s={B / steady:.1f}]")


def phase_preimage(cfg) -> str:
    out = []
    for n, L, bits, base, cols in cfg["shapes"]:
        params = RingParams.new(n, L, bits, base)
        ts = TrapdoorSampler(params, SIGMA, seed=2)
        td, a = ts.trapdoor(params, 1)
        target = UniformSampler(seed=3).sample_uniform(params, 1, cols, FinRingDist())
        c0 = _COMPILE_S[0]
        t0 = time.perf_counter()
        x = ts.preimage(params, td, a, target)
        x.data.block_until_ready()
        first = time.perf_counter() - t0
        compile_s = _COMPILE_S[0] - c0
        _check(a @ x == target, f"A x == U at n={n} L={L}")
        steady = _steady_s(lambda: ts.preimage(params, td, a, target).data)
        out.append(f"[d=1 cols={cols} n={n} L={L} bits={bits} base=2^{base} "
                   f"A_x_eq_U=exact first_call_s={first:.3f} "
                   f"first_call_compile_s={compile_s:.3f} "
                   f"cols_per_s={cols / steady:.1f}]")
    _check(chacha._self_test_vector(), "ChaCha20 RFC 8439 block vector")
    n, L, bits, base, _ = cfg["shapes"][0]
    params = RingParams.new(n, L, bits, base)
    rows, cols = cfg["gauss"]
    g = UniformSampler(seed=11).sample_uniform(params, rows, cols, GaussDist(SIGMA))
    q0 = params.moduli[0]
    v = np.asarray(g.data[0]).astype(np.int64).ravel()
    v = np.where(v > q0 // 2, v - q0, v).astype(np.float64)
    _check(abs(v.mean()) < 0.5 and abs(v.std() - SIGMA) < 0.5,
           f"Gaussian moments mean={v.mean()} std={v.std()}")
    out.append(f"[chacha_rfc8439=exact gauss_mean={v.mean():.4f} "
               f"gauss_std={v.std():.4f} sigma={SIGMA} samples={v.size}]")
    return " ".join(out)


def phase_lwe_chain(cfg) -> str:
    n, L, bits, base = cfg["ring"]
    with tempfile.TemporaryDirectory() as tmp:
        res = run_lwe_modp_chain(cfg["ring"], tmp)
    phases = " ".join(f"{k}={v:.3f}" for k, v in res["phases_s"].items())
    return (f"[lwe_modp_chain n={n} L={L} bits={bits} base=2^{base} decode=ok "
            f"error_bits={res['error_bits']} {phases}]")


def phase_four_cards(cfg) -> str:
    """Sharded offline planes on the default mesh of the first four devices,
    each against its single-device result."""
    _check(len(jax.devices()) >= 4, "four devices")
    n, L, bits, base = cfg["ring"]
    params = RingParams.new(n, L, bits, base)
    mesh = make_mesh(4)
    nl, nc = mesh.shape[LIMB_AXIS], mesh.shape[COL_AXIS]
    out = []

    ts = TrapdoorSampler(params, SIGMA, seed=5)
    td, a = ts.trapdoor(params, 1)
    target = UniformSampler(seed=6).sample_uniform(params, 1, cfg["cols"], FinRingDist())
    single = ts.preimage_batched_sharded(params, td, a, [target])[0]
    _check(a @ single == target, "single-device A x == U")
    sharded = ts.preimage_batched_sharded(params, td, a, [target], mesh=mesh)[0]
    shards = sharded.data.addressable_shards
    _check(len({s.device for s in shards}) == 4, "preimage columns on four devices")
    _check({s.data.shape[2] for s in shards} == {cfg["cols"] // 4},
           "each device holds a quarter of the columns")
    _check(a @ sharded == target, "sharded A x == U")
    out.append(f"[preimage_batched_sharded cols={cfg['cols']} n={n} L={L} "
               f"mesh=limb{nl}xcol{nc} ran_on=col4 shard_cols={shards[0].data.shape[2]} "
               f"A_x_eq_U=exact]")

    with tempfile.TemporaryDirectory() as tmp:
        res = run_lwe_modp_chain(cfg["ring"], tmp, lookups=1, mesh=mesh)
    out.append(f"[lwe_lut_k_high_plane mesh=limb{nl}xcol{nc} ran_on=col4 decode=ok "
               f"error_bits={res['error_bits']} "
               f"k_high_s={res['phases_s']['offline_k_high_sampling']:.3f}]")

    pmod = 1 << 16
    data = _residues(params, (2, 4), seed=9)
    sharded_in = jax.device_put(data, NamedSharding(mesh, P(LIMB_AXIS)))
    _check(len({s.device for s in sharded_in.addressable_shards}) == 4, "limbs on four devices")
    got = crt_switch_sharded(params, sharded_in, pmod, mesh)
    want = PolyMatrix(data, COEFF, params).modulus_switch(pmod).data[0]
    _check(bool(jnp.array_equal(got, want)), "CRT switch equals the single-device switch")
    rng = np.random.default_rng(3)
    flat = np.asarray(data).reshape(L, -1)
    got_flat = np.asarray(got).ravel()
    q = params.modulus
    idx = rng.integers(0, flat.shape[1], cfg["samples"])
    for j in idx:
        x = params.reconstruct_coeff(flat[:, j])
        _check(int(got_flat[j]) == (2 * x * pmod + q) // (2 * q) % pmod,
               f"CRT switch coefficient {j} against round(x P / q)")
    out.append(f"[crt_switch_sharded P=2^16 mesh=limb{nl}xcol{nc} limbs_per_shard="
               f"{sharded_in.addressable_shards[0].data.shape[0]} "
               f"host_rule={idx.size}/{idx.size} single_device=equal]")
    return " ".join(out)


PHASES = {
    "ntt": phase_ntt,
    "zq_matmul": phase_zq_matmul,
    "gsw_ext_prod": phase_gsw_ext_prod,
    "preimage": phase_preimage,
    "lwe_chain": phase_lwe_chain,
    "four_cards": phase_four_cards,
}


class _Outcomes:
    """pytest plugin that counts the outcomes of the test calls."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def run_gpu_tests(card: str):
    """The `gpu`-marked tests in this process: they must all run and pass."""
    import pytest

    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", str(ROOT / "tests")],
                     plugins=[outcomes])
    wall = time.perf_counter() - t0
    n = outcomes.counts
    _check(rc == 0 and n["passed"] > 0 and n["failed"] == n["skipped"] == 0,
           f"gpu-marked tests: exit {rc}, {n}")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(f"phase=gpu_tests check=pass [passed={n['passed']} failed=0 skipped=0] "
          f"compile_s={_COMPILE_S[0] - c0:.3f} wall_s={wall:.3f} "
          f"peak_bytes_in_use={peak} card=\"{card}\"", flush=True)


def _run_phase(name: str, card: str, n_devices: int):
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    detail = PHASES[name](FULL[name])
    wall = time.perf_counter() - t0
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:n_devices]]
    _check(all(p > 0 for p in peaks), f"nonzero peak memory on every device: {peaks}")
    print(f"phase={name} check=pass {detail} compile_s={_COMPILE_S[0] - c0:.3f} "
          f"wall_s={wall:.3f} peak_bytes_in_use={','.join(map(str, peaks))} "
          f"card=\"{card}\"", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded planes, on four GPUs")
    args = ap.parse_args(argv)

    enable_compile_cache()
    dev = require_gpu("chip_smoke")
    count = len(jax.devices())
    if args.four_cards and count != 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {count}", file=sys.stderr)
        raise SystemExit(1)
    cards = nvidia_smi_cards()
    card = f"{dev.device_kind}; {' / '.join(cards)}"
    print(f"phase=device platform={dev.platform} kind={dev.device_kind} "
          f"count={count} check=pass card=\"{card}\"", flush=True)
    names = ["four_cards"] if args.four_cards else ONE_CARD_PHASES
    for name in names:
        _run_phase(name, card, 4 if args.four_cards else 1)
    if not args.four_cards:
        run_gpu_tests(card)
    print("\n".join(cards), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
