"""Probe: real-mode Diamond iO PRF path at the smallest CI config.

Times each phase of obfuscate/eval with tracing spans so the real-mode test
(VERDICT r2 directive #1) can be sized. Scope: the PRF/refresh pipeline runs
in REAL mode (no debug_encrypt_random_prg_wires, no reuse_single_material,
every wire refreshed); the LUT gates still use the TEST-ONLY secret-oracle
debug evaluators, so these timings exclude the production storage-backed LWE
lookup cost. Run on CPU:

    JAX_PLATFORMS=cpu python scripts/real_mode_probe.py
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
from mxx_tpu.lookup.debug import (
    DebugBGGEncodingPltEvaluator,
    DebugBGGPubKeyPltEvaluator,
)


def main():
    enable_compile_cache()
    import tempfile

    params = RingParams.new(2, 2, 9, 9)
    cfg = PrfConfig(
        seed_bits=5,
        prf_mask_output_coeff_bits=1,
        p_moduli_bits=8,
        # >= 2: a GSW external product multiplies two FULL-REDUCED values, so
        # the p-basis budget must cover ((sum_p + k) * q)^2 (muls=1 only
        # covers decrypt-style const muls and fails the mul budget assert)
        max_unreduced_muls=2,
        noise_refresh_v_bits=1,
        p_basis="wide",
        # REAL MODE: no debug flags, every wire refreshed
        debug_encrypt_random_prg_wires=False,
        debug_reuse_single_material=False,
        refresh_wire_limit=None,
    )
    dio = DiamondIO(
        params, input_count=1, batch_bits=1, seed=7,
        prf_config=cfg,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)
            ),
    )
    # shape diagnostics only; _prf_pipeline is keyed on the hash key, so this
    # early probe pipeline is rebuilt once obfuscate() sets the real key
    prf = dio._prf_pipeline()
    print(f"wires_per_ct={prf.wires_per_ct} seed_wires={cfg.seed_bits * prf.wires_per_ct}")
    print(f"nested k={prf.ctx.nested.k} depth={prf.ctx.nested.q_moduli_depth} "
          f"gadget_len={prf.ctx.gadget_len}")

    def builder(circuit, bits):
        return [bits[0]]

    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        obf = dio.obfuscate(d, builder)
        t1 = time.time()
        print(f"obfuscate: {t1 - t0:.1f}s")
        for bits in ([0], [1]):
            t2 = time.time()
            out = dio.eval(d, obf, builder, bits)
            print(f"eval({bits}) -> {out} in {time.time() - t2:.1f}s")
            assert out == [bits[0]], (bits, out)
    print("REAL MODE OK")


if __name__ == "__main__":
    main()
