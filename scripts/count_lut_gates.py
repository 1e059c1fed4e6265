"""Count PubLut gate instances + table sizes in the Diamond CI circuits, to
size the production-LWE-evaluator e2e test (VERDICT r2 directive #4)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxx_tpu  # noqa: F401
from mxx_tpu.utils.compile_cache import enable_compile_cache
from mxx_tpu.ring.params import RingParams
from mxx_tpu.io_protocols import DiamondIO
from mxx_tpu.io_protocols.prf_mask import PrfConfig


def main():
    enable_compile_cache()
    params = RingParams.new(4, 3, 10, 10)
    cfg = PrfConfig(
        seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
        max_unreduced_muls=1, noise_refresh_v_bits=1,
        debug_encrypt_random_prg_wires=True, debug_reuse_single_material=True,
        refresh_wire_limit=1,
    )
    dio = DiamondIO(params, input_count=2, batch_bits=1, seed=42, prf_config=cfg)
    dio._hash_key = b"\x01" * 32
    prf = dio._prf_pipeline()
    print(f"nested k={prf.ctx.nested.k} p_moduli={prf.ctx.nested.p_moduli}")
    print(f"lut_mod_p_domain={prf.ctx.nested.lut_mod_p_domain}")

    def builder(circuit, bits):
        return [circuit.xor_gate(bits[0], bits[1])]

    circuit = dio._build_wrapped_circuit(
        prf, builder, (3, 5), 1,
        type("D", (), {"final_mask_cts": [[]]})(),
    ) if False else None

    # count PubLut gates in the main wrapped circuit (debug-replay shape needs
    # real mask cts; use the decrypt circuit instead, which dominates)
    from mxx_tpu.noise_refresh.naive_vec import (
        build_refreshed_wire_digit_all_crt_decrypt,
    )

    c = build_refreshed_wire_digit_all_crt_decrypt(
        prf.ctx, 1, n_coeffs=1, mask_levels=1
    )
    from collections import Counter

    kinds = Counter()
    lut_gates = []
    for g in c.gates:
        kinds[g.kind] += 1
        if g.kind == "PubLut":
            lut_gates.append(g)
    print(f"decrypt circuit: {c.num_gates()} gates, kinds={dict(kinds)}")
    total_entries = 0
    per_lut = Counter()
    for g in lut_gates:
        lut = c.luts[g.payload]
        n_e = len(list(lut.entries(params)))
        total_entries += n_e
        per_lut[g.payload] += 1
    print(f"pub_lut gates={len(lut_gates)} total K_high rows={total_entries}")
    print(f"per lut_id gate counts: {dict(per_lut)}")
    for lid in per_lut:
        print(f"  lut {lid}: {len(list(c.luts[lid].entries(params)))} entries")


if __name__ == "__main__":
    main()
