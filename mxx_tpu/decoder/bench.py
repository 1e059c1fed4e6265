"""Masked-decoder benchmark scaling.

Build of the reference's src/decoder/bench.rs (343 LoC): measures the
per-output masked-decode cost (projection matmul + G^{-1} fold + coefficient
extraction) at the target parameters and extrapolates over output counts, so
protocol estimators can price wide-output decoders without running them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax

from ..matrix import PolyMatrix
from ..sampler import FinRingDist, UniformSampler


@dataclass
class DecoderBenchEstimate:
    per_output_secs: float
    outputs: list
    latency_secs: list  # per outputs[i], with the given parallelism


def measure_masked_decode_cost(params, secret_size: int = 1,
                               iterations: int = 3) -> float:
    """Median wall time of ONE masked decode: proj - c_sd @ G^{-1}(e_0) and
    the top-coefficient extraction (diamond_io.rs:1053-1146 online decode)."""
    us = UniformSampler(seed=7)
    d = secret_size
    m_g = d * params.modulus_digits
    sel = PolyMatrix.identity(params, d).slice_columns(0, 1)
    c_sd = us.sample_uniform(params, 1, m_g, FinRingDist())
    proj = us.sample_uniform(params, 1, sel.ncol, FinRingDist())

    def op():
        noisy = proj - c_sd.mul_decompose(sel)
        jax.block_until_ready(noisy.data)
        return noisy.entry(0, 0).coeffs()[0]

    op()  # warm the jit caches
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        op()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def estimate_decoder_scaling(params, output_counts: list, secret_size: int = 1,
                             parallelism: int = 1,
                             per_output_cost: float | None = None
                             ) -> DecoderBenchEstimate:
    """Extrapolate masked-decode latency over output counts (reference
    decoder/bench.rs scaling table)."""
    if per_output_cost is None:
        per_output_cost = measure_masked_decode_cost(params, secret_size)
    return DecoderBenchEstimate(
        per_output_secs=per_output_cost,
        outputs=list(output_counts),
        latency_secs=[
            n * per_output_cost / max(parallelism, 1) for n in output_counts
        ],
    )
