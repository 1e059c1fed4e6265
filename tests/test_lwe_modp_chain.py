"""End-to-end LWE public-LUT mod-p chain: offline pubkey path + online
encoding path + masked-rounding decode.

Mirror of the reference's tests/test_lwe_modp_chain.rs:29-300
(smaller but non-trivial parameters; the reference uses n=2^10, crt_bits=51 —
our u32-limb design caps crt_bits at 30, so depth compensates).
"""

import random

import pytest

import mxx_tpu  # noqa: F401

pytestmark = pytest.mark.slow

from mxx_tpu.ring.params import RingParams
from mxx_tpu.ring.poly import Poly
from mxx_tpu.matrix import PolyMatrix
from mxx_tpu.sampler import GaussDist, TernaryDist, TrapdoorSampler, UniformSampler
from mxx_tpu.bgg import BGGEncodingSampler, BGGPublicKeySampler
from mxx_tpu.circuit import PolyCircuit
from mxx_tpu.lookup import PublicLut, PolyPltEvaluator
from mxx_tpu.lookup.lwe import LWEBGGEncodingPltEvaluator, LWEBGGPubKeyPltEvaluator
from mxx_tpu.storage import init_storage_system, wait_for_all_writes

P_MOD = 7
ERROR_SIGMA = 4.0
TRAPDOOR_SIGMA = 4.578
KEY = bytes([0x5F, 0x92, 0x10, 0x6A] * 8)


def build_mod_p_lut(params, p):
    # x in [0, p^2) -> (row x, x mod p)
    return PublicLut.from_dict(params, {x: (x, x % p) for x in range(p * p)})


def build_modp_chain_circuit(params, p):
    circuit = PolyCircuit()
    inputs = circuit.input(3)
    lut_id = circuit.register_public_lut(build_mod_p_lut(params, p))
    t1 = circuit.mul_gate(inputs[0], inputs[1])
    t1_mod = circuit.public_lookup_gate(t1, lut_id)
    t2 = circuit.mul_gate(t1_mod, inputs[2])
    t2_mod = circuit.public_lookup_gate(t2, lut_id)
    circuit.output([t2_mod])
    return circuit


def test_lwe_modp_chain_rounding(tmp_path):
    # depth/base chosen so the simulated error stays below q/(2p): each
    # G^{-1}-multiplication grows the error by ~base * m * n (m = d*k).
    params = RingParams.new(16, 4, 28, 7)
    q = params.modulus
    assert P_MOD * P_MOD < min(params.moduli)
    q_over_p = q // P_MOD
    circuit = build_modp_chain_circuit(params, P_MOD)

    rng = random.Random(1234)
    a, b, c = (rng.randrange(P_MOD) for _ in range(3))
    expected_mod_p = ((a * b) % P_MOD) * c % P_MOD
    plaintexts = [Poly.const(params, v) for v in (a, b, c)]

    d_secret = 1
    pk_sampler = BGGPublicKeySampler(KEY, d_secret)
    us = UniformSampler(seed=77)
    secrets = [us.sample_poly(params, TernaryDist()) for _ in range(d_secret)]
    pubkeys = pk_sampler.sample(params, b"bgg_pubkey", [True] * 3)
    enc_sampler = BGGEncodingSampler(params, secrets, gauss_sigma=ERROR_SIGMA, seed=78)
    encodings = enc_sampler.sample(params, pubkeys, plaintexts)
    s_vec = enc_sampler.secret_vec

    trap_sampler = TrapdoorSampler(params, TRAPDOOR_SIGMA, seed=79)
    b0_trapdoor, b0_matrix = trap_sampler.trapdoor(params, d_secret)

    init_storage_system(tmp_path)

    # --- plaintext oracle
    pt_out = circuit.eval(
        params, Poly.one(params), plaintexts, plt_evaluator=PolyPltEvaluator()
    )[0]
    assert pt_out.const_coeff() == expected_mod_p

    # --- offline: pubkey path
    pk_eval = LWEBGGPubKeyPltEvaluator(KEY, trap_sampler, b0_matrix, b0_trapdoor, tmp_path)
    result_pubkey = circuit.eval(
        params, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval
    )
    assert len(result_pubkey) == 1
    pk_eval.sample_aux_matrices(params)
    wait_for_all_writes()

    # --- online: encoding path
    c_b = s_vec @ b0_matrix
    enc_eval = LWEBGGEncodingPltEvaluator(KEY, tmp_path, c_b)
    result_encoding = circuit.eval(
        params, encodings[0], encodings[1:], plt_evaluator=enc_eval
    )
    assert len(result_encoding) == 1
    encoding = result_encoding[0]

    # symbolic plaintext matches
    assert encoding.plaintext.const_coeff() == expected_mod_p
    # output pubkey consistency: online A_LT equals the offline one
    assert encoding.pubkey.matrix == result_pubkey[0].matrix

    # BGG relation with noise: c - s*A + x*(s*G) must be small
    expected_poly = Poly.const(params, expected_mod_p)
    s_times_pk = s_vec @ encoding.pubkey.matrix
    gadget = PolyMatrix.gadget_matrix(params, d_secret)
    expected_times_gadget = (s_vec @ gadget).mul_poly_scalar(expected_poly)
    diff = encoding.vector - s_times_pk + expected_times_gadget
    # masked rounding decode (reference test:281-299)
    random_int = rng.randrange(P_MOD)
    coeff = diff.entry(0, 0).coeffs()[0]
    # error must be below q/(2p) for correct rounding
    err_centered = min(coeff, q - coeff)
    assert err_centered < q_over_p // 2, f"error too large: {err_centered} vs {q_over_p//2}"
    randomized = coeff + q_over_p * random_int
    rounded = (randomized + q_over_p // 2) // q_over_p
    assert rounded % P_MOD == random_int
