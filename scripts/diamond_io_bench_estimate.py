"""Produce the DiamondIO benchmark-estimation CSV from costs measured on the
device this runs on (written to bench/diamond_io_estimates.csv).

Mirror of the reference's committed estimation table
(/root/reference/bench/security_bits_100_diamond_io_simulation_parameters.csv):
per configuration row, measured per-op costs extrapolated to obfuscate/eval
latency, parallelism, and artifact bytes.
"""

import csv
import sys
from pathlib import Path

sys.path.insert(0, ".")

import mxx_tpu  # noqa: F401
import jax
from mxx_tpu.utils.compile_cache import enable_compile_cache

from mxx_tpu.ring.params import RingParams
from mxx_tpu.io_protocols import DiamondIO
from mxx_tpu.io_protocols.bench_estimator import estimate_diamond_io
from mxx_tpu.io_protocols.prf_mask import PrfConfig


def and_builder(circuit, bits):
    acc = bits[0]
    for b in bits[1:]:
        acc = circuit.and_gate(acc, b)
    return [acc]


# Rows are COST-MODEL anchors (measured per-op costs composed over the
# protocol phase structure) at shapes whose wrapped circuit fits host RAM as
# Python gate objects — the gate count grows ~quadratically with the GSW
# gadget length (~gl^2 * k^2), and a depth-8 n=4096 wrapped circuit
# OOM-killed a 128 GB host (round-5 log). Production-scale latencies live in
# bench/security_bits_100_diamond_io_parameters.csv, which extrapolates with
# a documented model instead of materializing the circuit.
CONFIGS = [
    # (input_count, batch_bits, n, depth, crt_bits, base_bits)
    (4, 2, 256, 3, 28, 14),
    (8, 2, 256, 3, 28, 14),
    (4, 2, 1024, 3, 28, 14),
]


def main():
    enable_compile_cache()
    from mxx_tpu.bench_estimator import measure_bgg_encoding_costs
    from mxx_tpu.io_protocols.bench_estimator import measure_preimage_cost

    out = Path("bench")
    out.mkdir(exist_ok=True)
    rows = []
    # measure per-op costs ONCE per (n, depth) shape and share across rows,
    # so near-identical circuits are priced with the same costs
    cost_cache = {}
    for input_count, batch_bits, n, depth, crt_bits, base_bits in CONFIGS:
        params = RingParams.new(n, depth, crt_bits, base_bits)
        if (n, depth) not in cost_cache:
            cost_cache[(n, depth)] = (
                measure_preimage_cost(params),
                measure_bgg_encoding_costs(params),
            )
        preimage_cost, gate_costs = cost_cache[(n, depth)]
        # wide p-basis hosts the nested-RNS budget at 28-bit limbs; the
        # packed per-R'-coeff mask channel keeps mask bits per output at
        # payload_slots instead of n (the scalar channel's Goldreich PRG
        # stretch bound rejects n=4096 outputs from a CI-sized seed)
        cfg = PrfConfig(seed_bits=5, max_unreduced_muls=2, p_moduli_bits=16,
                        p_basis="wide", nested_rns_scale=256,
                        refresh_wire_limit=1)
        dio = DiamondIO(params, input_count, batch_bits, seed=1,
                        prf_config=cfg, payload_slots=4)
        est = estimate_diamond_io(dio, and_builder, parallelism=8,
                                  preimage_cost=preimage_cost,
                                  gate_costs=gate_costs)
        print(f"  (preimage_cost={preimage_cost:.3f}s)", flush=True)
        rows.append(
            {
                "input_bits": input_count * batch_bits,
                "ring_dim": n,
                "crt_depth": depth,
                "crt_bits": crt_bits,
                "base_bits": base_bits,
                "obfuscate_latency_secs": round(est.obfuscate_latency_secs, 3),
                "eval_latency_secs": round(est.eval_latency_secs, 3),
                "total_time_secs": round(est.total_time_secs, 3),
                "max_parallelism": est.max_parallelism,
                "injector_preimages": est.injector_preimage_count,
                "artifact_bytes": est.artifact_bytes,
            }
        )
        print(rows[-1], flush=True)
    device = jax.devices()[0]
    with open(out / "diamond_io_estimates.csv", "w", newline="") as f:
        f.write(f"# per-op costs measured on {device.platform} {device.device_kind}\n")
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


if __name__ == "__main__":
    main()
