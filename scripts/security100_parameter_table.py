"""Produce this repo's production parameter table at the reference's
security-100 grid (VERDICT r4 directive #4): the analog of
/root/reference/bench/security_bits_100_diamond_io_simulation_parameters.csv
(produced there by src/io/diamond_io/simulation.rs + the lattice estimator
+ GPU-measured per-op costs; note the reference row metadata:
search_only=true, latency = critical path under UNBOUNDED parallelism —
its total_time column is ~1e57 ns).

Methodology (every number either closed-form or fitted as documented):

1. **Composed error budget.** The circuit phases (PRG round edge, mask
   decrypt) cannot be norm-walked directly at production shape: one PRG
   edge is ~gl^2 k^2 gates (8.7M at gl=42; ~700M at gl=371), which is why
   the reference has a native eval_error engine. Instead the phase
   amplification BITS are measured with the full circuit-accurate
   simulation (io_protocols/protocol_simulation.py) on a (n, gl) grid and
   fitted as

       amp_prg(gl, n)  = a + b*log2(gl) + c*log2(n)      [PRG edge]
       off_mask(gl, n) = d + e*log2(gl) + f*log2(n)      [decrypt offset]

   (measured grid and residuals in the CSV header; the fit is linear in
   logs because the circuits have FIXED multiplicative depth — each
   external product multiplies the norm bound by ~gl*sqrt(n)*const).
   The remaining phases are closed-form at production shape: injector
   input composition, rebase/decoder preimage terms, the noise-refresh
   rounding growth, and the q/4 margin.
2. **Security bits** from the lattice-estimator bridge
   (lattice-estimator-cli when installed, else the core-SVP fallback) at
   (n=65536, log2 q = depth*28, sigma 3.19).
3. **Latency floor**: obfuscate_floor = total preimage work / parallelism,
   which needs the measured preimage throughput at n=65536, L=53 on the
   GPU. No such cell exists yet, so the column reads "not measured".

Sanity gate (VERDICT r4 #4): the budget margin must be POSITIVE at the
selected depth.

Run: python scripts/security100_parameter_table.py (host arithmetic only).

AKY24 iO / FE share every phase of this budget except the input
composition (fresh Gaussian sigma*tail ~ 5+log2(6.5*sigma*sqrt(n)) bits
instead of the injector chain's ~500): the same fitted amplification and
closed-form refresh/mask composition applies with the smaller input term,
so AKY24 margins dominate the Diamond rows at equal (depth, v)
(reference aky24 error_simulation.rs shares the machinery the same way).
"""

import csv
import math
import sys
from pathlib import Path

sys.path.insert(0, ".")

import mxx_tpu  # noqa: F401
from mxx_tpu.utils.compile_cache import enable_compile_cache

N_PROD = 65536
CRT_BITS = 28
BASE_BITS = 14
PARALLELISM = 8

CONFIGS = [(8, 10), (9, 10), (10, 10), (11, 10)]

# ---- measured budget-fit grid (scripts/budget_fit run, round 5; full
# circuit-accurate composed simulation, PrfConfig(p=16 wide, muls=2),
# error_sigma=4, trapdoor_sigma=4.578, d_secret=1) -----------------------
# (n, gl, amp_prg_bits, mask_offset_bits)
FIT_GRID = [
    (256, 14, 504, 145),
    (256, 28, 516, 151),
    (256, 42, 525, 154),
    (1024, 28, 539, 159),
    (1024, 42, 548, 162),
]


def _lstsq_fit(rows):
    """Least-squares fit bits = a + b*log2(gl) + c*log2(n)."""
    import numpy as np

    A = np.array([[1.0, math.log2(gl), math.log2(n)] for n, gl, _, _ in rows])
    out = []
    for col in (2, 3):
        y = np.array([r[col] for r in rows], dtype=float)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid = y - A @ coef
        out.append((coef, float(max(abs(resid)))))
    return out


def compose_budget(depth: int, input_count: int, batch_bits: int,
                   prg_coef, mask_coef, v_bits: int):
    """Closed-form phase composition at production shape using the fitted
    circuit-phase amplifications. Returns (margin_bits, phases dict)."""
    from decimal import Decimal

    from mxx_tpu.input_injector import DiamondInjector
    from mxx_tpu.io_protocols.diamond_io import DIAMOND_SECRET_SIZE
    from mxx_tpu.io_protocols.protocol_simulation import (
        diamond_compose_input_error,
    )
    from mxx_tpu.noise_refresh.refresh import (
        pre_rounding_bound_holds,
        simulate_noise_refresh_error_growth,
    )
    from mxx_tpu.ring.params import RingParams
    from mxx_tpu.simulator import (
        SimulatorContext,
        bits_ceil,
        compute_preimage_norm,
    )

    params = RingParams.new(N_PROD, depth, CRT_BITS, BASE_BITS)
    ctx = SimulatorContext.for_params(params, DIAMOND_SECRET_SIZE)
    injector = DiamondInjector(
        params, input_count, 1 << batch_bits, batch_bits, 4.578, 4.0,
        secret_size=DIAMOND_SECRET_SIZE,
    )
    e_enc, worst_state = diamond_compose_input_error(params, injector, 4.578)
    input_bits = bits_ceil(Decimal(e_enc))

    gl = -(-params.modulus.bit_length() // 4)  # base-16 GSW gadget length
    amp = prg_coef[0] + prg_coef[1] * math.log2(gl) + prg_coef[2] * math.log2(N_PROD)
    off = mask_coef[0] + mask_coef[1] * math.log2(gl) + mask_coef[2] * math.log2(N_PROD)

    preimage_norm = compute_preimage_norm(
        ctx.ring_dim_sqrt, ctx.m_g, Decimal(1 << BASE_BITS),
        b_nrow=DIAMOND_SECRET_SIZE, sigma=4.578,
    )
    decoder_term = Decimal(worst_state) * preimage_norm * Decimal(ctx.m_b).sqrt()
    decoder_bits = bits_ceil(decoder_term)
    q_bits = params.modulus_bits

    # two representative rounds (first + steady state), like the direct sim
    seed_bits_err = input_bits
    refreshed_bits = None
    pre_round_ok = True
    for _ in range(2):
        prg_bits = int(math.ceil(seed_bits_err + amp))
        rebase = Decimal(2) ** prg_bits + decoder_term
        if not pre_rounding_bound_holds(rebase, q_bits, v_bits):
            pre_round_ok = False
        refreshed = simulate_noise_refresh_error_growth(
            ctx, rebase, v_bits, depth, 2, q_bits
        ) + decoder_term * Decimal(depth)
        refreshed_bits = bits_ceil(refreshed)
        seed_bits_err = refreshed_bits
    mask_bits = int(math.ceil(refreshed_bits + amp + off))
    fn_bits = input_bits + 30  # 1-gate function circuit + G^{-1} fold slack
    total = max(mask_bits, fn_bits, decoder_bits) + 2  # bit-level sum slack
    q4 = (params.modulus // 4).bit_length()
    margin = q4 - total
    return margin, {
        "input": input_bits, "amp": round(amp, 1), "refreshed": refreshed_bits,
        "mask": mask_bits, "decoder": decoder_bits, "total": total,
        "q4": q4, "pre_round_ok": pre_round_ok, "gl": gl,
    }


def main():
    enable_compile_cache()
    from mxx_tpu.input_injector import DiamondInjector
    from mxx_tpu.io_protocols.diamond_io import DIAMOND_SECRET_SIZE
    from mxx_tpu.ring.params import RingParams
    from mxx_tpu.simulator.lattice_estimator import (
        core_svp_security_bits,
        estimator_cli_available,
    )

    (prg_coef, prg_resid), (mask_coef, mask_resid) = _lstsq_fit(FIT_GRID)
    print(f"fit: amp = {prg_coef[0]:.1f} + {prg_coef[1]:.1f} log2(gl) + "
          f"{prg_coef[2]:.1f} log2(n)  (max resid {prg_resid:.1f} bits)")
    print(f"fit: off = {mask_coef[0]:.1f} + {mask_coef[1]:.1f} log2(gl) + "
          f"{mask_coef[2]:.1f} log2(n)  (max resid {mask_resid:.1f} bits)")

    rows = []
    REF_DEPTHS = {8: 50, 9: 51, 10: 53, 11: 55}
    for input_count, batch_bits in CONFIGS:
        # Depth: the reference grid's selected depth for the same input bits
        # (its search runs under tighter centered-residue norm accounting).
        # Our own worst-case composed budget CANNOT certify the real-mode
        # steady state at ANY (depth, v): the refreshed error is the
        # rounding granularity q/2^v, and the next PRG round amplifies it by
        # `amp` bits, so pre-rounding demands (q_bits - v) + amp <
        # q_bits - v - 1, i.e. amp < -1 — unsatisfiable for worst-case
        # bounds (the budget's own code, protocol_simulation.py +
        # noise_refresh/refresh.py; the VALIDATED-at-n-256 replay-mode
        # budget below is the one with meaningful margins).
        depth = REF_DEPTHS[input_count]
        v_bits = 756  # reference row value, reported for comparability
        margin, phases = compose_budget(
            depth, input_count, batch_bits, prg_coef, mask_coef, v_bits
        )

        # replay-mode margin (the budget validated against observation in
        # test_noise_regime.py): mask cts are fresh encryptions, no PRG
        # round evolution — mask = fresh-ct bits + fitted decrypt offset
        fresh_bits = math.ceil(math.log2(6.5 * 4.0) + 0.5 * math.log2(N_PROD))
        off = mask_coef[0] + mask_coef[1] * math.log2(phases["gl"]) \
            + mask_coef[2] * math.log2(N_PROD)
        replay_mask = int(math.ceil(fresh_bits + off))
        replay_total = max(replay_mask, phases["input"] + 30,
                           phases["decoder"]) + 2
        replay_margin = phases["q4"] - replay_total

        log2q = depth * CRT_BITS
        sec = core_svp_security_bits(N_PROD, log2q, 3.19)
        cli = estimator_cli_available()

        params = RingParams.new(N_PROD, depth, CRT_BITS, BASE_BITS)
        k_digits = params.modulus_digits
        base = 1 << batch_bits
        injector = DiamondInjector(
            params, input_count, base, batch_bits, 4.578, 4.0,
            secret_size=DIAMOND_SECRET_SIZE,
        )
        injector_preimages = sum(
            base * injector.state_count_at_level(level)
            for level in range(1, input_count + 1)
        )
        state_cols = 2 * DIAMOND_SECRET_SIZE * (k_digits + 2)
        entry_bytes = -(-depth * CRT_BITS * N_PROD // 8)
        artifact_bytes = injector_preimages * state_cols * state_cols * entry_bytes

        rows.append({
            "input_bits": input_count * batch_bits,
            "input_count": input_count,
            "batch_bits": batch_bits,
            "ring_dim": N_PROD,
            "crt_depth": depth,
            "crt_bits": CRT_BITS,
            "base_bits": BASE_BITS,
            "gadget_len": phases["gl"],
            "security_bits": round(sec, 1),
            "security_source": "lattice-estimator-cli" if cli else "core-SVP fallback",
            "replay_budget_margin_bits": replay_margin,
            "replay_total_error_bits": replay_total,
            "worstcase_input_error_bits": phases["input"],
            "worstcase_prg_amp_bits": float(phases["amp"]),
            "worstcase_mask_error_bits": phases["mask"],
            "worstcase_margin_bits": margin,
            "steady_state_pre_rounding_feasible_worstcase": False,
            "injector_preimages": injector_preimages,
            f"obfuscate_floor_secs_par{PARALLELISM}": "not measured",
            "est_artifact_bytes": artifact_bytes,
        })
        print(rows[-1], flush=True)

    out_path = Path("bench/security_bits_100_diamond_io_parameters.csv")
    out_path.parent.mkdir(exist_ok=True)
    with out_path.open("w", newline="") as f:
        f.write("# methodology: see scripts/security100_parameter_table.py "
                "module doc (fitted circuit-phase bits + closed-form "
                "composition; latency floor not measured)\n")
        f.write(f"# fit grid (n, gl, amp_prg_bits, mask_offset_bits): {FIT_GRID}\n")
        f.write(f"# fit residuals: amp {prg_resid:.1f} bits, off {mask_resid:.1f} bits\n")
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
