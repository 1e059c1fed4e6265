"""Headline benchmarks on one GPU, one JSON line each.

Line 1: forward negacyclic NTT chain throughput at n=2^13, L=8, B=512.
Line 2: trapdoor preimage throughput at the reference's bench_preimage shape
        (d=1, 50 cols, n=2^14, L=10, 24-bit limbs, base 2^12).
Line 3: RingGSW external-product throughput C · G^{-1}(c) at n=2^13, L=8,
        base 2^14, B=64.

Each line is {"metric", "value", "unit", "platform", "device_kind",
"device_count", "card"}, where "card" is nvidia-smi's `name, power.limit`.
Times end in `block_until_ready` and exclude the first (compiling) call. The
script exits non-zero when JAX's first device is not a GPU.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import mxx_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mxx_tpu.ring.ntt import ntt_fwd
from mxx_tpu.ring.params import RingParams
from mxx_tpu.utils.compile_cache import enable_compile_cache
from mxx_tpu.utils.device import nvidia_smi_cards, require_gpu

N = 1 << 13
L = 8
BATCH = 512
ITERS = 10


def emit(device, card, metric, value, unit):
    print(json.dumps({
        "metric": metric, "value": value, "unit": unit,
        "platform": device.platform, "device_kind": device.device_kind,
        "device_count": len(jax.devices()), "card": card,
    }), flush=True)


def timed(op, iters):
    """Mean seconds per call of `op` after one compiling call."""
    jax.block_until_ready(op())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = op()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_ntt():
    params = RingParams.new(N, L, 28, 14)
    jt = params.jt
    rng = np.random.default_rng(0)
    x = np.empty((L, BATCH, N), dtype=np.uint32)
    for t, q in enumerate(params.moduli):
        x[t] = rng.integers(0, q, size=(BATCH, N), dtype=np.uint64).astype(np.uint32)
    x = jnp.asarray(x)
    # ITERS chained transforms in one program, so no iteration can be elided
    fn = jax.jit(lambda v: lax.fori_loop(
        0, ITERS, lambda i, a: ntt_fwd(a, jt.psi_rev_mont, jt.moduli, jt.qinv_neg), v))
    el = timed(lambda: fn(x), 1)
    return f"ntt_limb_transforms_per_s_n{N}_L{L}", L * BATCH * ITERS / el, "limb-NTTs/s"


def bench_preimage(n=1 << 14, L_pre=10, crt_bits=24, base_bits=12, cols=50, iters=3):
    """Reference bench_preimage workload (benches/bench_preimage_gpu.rs:7-57):
    d=1 trapdoor, 50-column target."""
    from mxx_tpu.sampler import FinRingDist, TrapdoorSampler, UniformSampler

    params = RingParams.new(n, L_pre, crt_bits, base_bits)
    ts = TrapdoorSampler(params, 4.578, seed=2)
    td, a = ts.trapdoor(params, 1)
    target = UniformSampler(seed=3).sample_uniform(params, 1, cols, FinRingDist())
    el = timed(lambda: ts.preimage(params, td, a, target).data, iters)
    return f"preimage_cols_per_s_d1_n{n}_L{L_pre}", cols / el, "preimage-cols/s"


def bench_gsw_ext_prod(n=1 << 13, L_gsw=8, crt_bits=28, base_bits=14, B=64, iters=3):
    """RingGSW external product C · G^{-1}(c): gadget decomposition of a
    [2, B] ciphertext-column batch + eval-domain matmul with a [2, 2k] GSW
    ciphertext (reference MatrixDecompose.cu + MatrixArith.cu composition;
    one ext-prod = one ciphertext column)."""
    from mxx_tpu.sampler import FinRingDist, UniformSampler

    params = RingParams.new(n, L_gsw, crt_bits, base_bits)
    k = params.modulus_digits
    us = UniformSampler(seed=4)
    c_mat = us.sample_uniform(params, 2, 2 * k, FinRingDist()).to_eval()
    cts = us.sample_uniform(params, 2, B, FinRingDist())
    el = timed(lambda: (c_mat @ cts.decompose()).data, iters)
    return f"gsw_ext_prods_per_s_n{n}_L{L_gsw}_B{B}", B / el, "ext-prods/s"


def main():
    enable_compile_cache()
    device = require_gpu("bench")
    card = " / ".join(nvidia_smi_cards())
    for bench in (bench_ntt, bench_preimage, bench_gsw_ext_prod):
        emit(device, card, *bench())


if __name__ == "__main__":
    main()
