"""Diamond iO e2e over the PRODUCTION storage-backed LWE LUT evaluators
(VERDICT r2 directive #4): no debug LUT oracle — the default evaluator
factories exercise the lut_bridge preimage (diamond_io.py offline), the
per-gate K_high trapdoor preimages persisted through the artifact store, and
the online c_b @ K_high + c_z @ K_low path (diamond_io.py online).

The PRF pipeline runs in debug-replay mode (the reference's own e2e test
mode) so this run isolates the production LOOKUP path; the real-mode PRG
path is exercised separately by real_mode_probe.py / the real-mode test.

Offline cost is dominated by per-LUT-entry K_high preimages: every PubLut
gate instance needs one preimage per table entry (the reference's production
offline has the same profile, lwe/pubkey.rs:217-608 — its Diamond e2e runs
are GPU-scale for the same reason). nested_rns_scale shrinks the v-rounding
LUT from ~459k entries (k * 2^16) to k * scale.

    python scripts/production_lwe_diamond.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxx_tpu  # noqa: F401
from mxx_tpu.utils.compile_cache import enable_compile_cache
from mxx_tpu.ring.params import RingParams
from mxx_tpu.io_protocols import DiamondIO
from mxx_tpu.io_protocols.prf_mask import PrfConfig


def main():
    enable_compile_cache()
    import tempfile

    params = RingParams.new(4, 3, 10, 10)
    cfg = PrfConfig(
        seed_bits=2,
        prf_mask_output_coeff_bits=1,
        p_moduli_bits=5,
        max_unreduced_muls=1,
        noise_refresh_v_bits=1,
        nested_rns_scale=64,  # v-rounding LUT: k*64 entries instead of k*2^16
        debug_encrypt_random_prg_wires=True,
        debug_reuse_single_material=True,
        refresh_wire_limit=1,
    )
    # DEFAULT evaluator factories = production storage-backed LWE path
    dio = DiamondIO(params, input_count=1, batch_bits=1, seed=11, prf_config=cfg)

    def builder(circuit, bits):
        return [bits[0]]

    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        obf = dio.obfuscate(d, builder)
        t1 = time.time()
        print(f"obfuscate(production LWE): {t1 - t0:.1f}s", flush=True)
        n_art = len(os.listdir(d))
        total_bytes = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
        )
        print(f"artifacts: {n_art} files, {total_bytes / 1e6:.1f} MB", flush=True)
        for bits in ([0], [1]):
            t2 = time.time()
            out = dio.eval(d, obf, builder, bits)
            print(f"eval({bits}) -> {out} in {time.time() - t2:.1f}s", flush=True)
            assert out == [bits[0]], (bits, out)
    print("PRODUCTION LWE DIAMOND OK")


if __name__ == "__main__":
    main()
