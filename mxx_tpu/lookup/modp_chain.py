"""End-to-end LWE public-LUT mod-p chain over the storage-backed evaluators.

The reference's test_lwe_modp_chain.rs workload: x0 * x1 mod p, then times
x2 mod p, each reduction a public lookup gate. One run covers the offline
pubkey circuit eval, the K_high preimage sampling written to an artifact
directory, the online encoding eval that reads those artifacts back, and a
masked-rounding decode against the plaintext oracle.
`scripts/realistic_scale_run.py` and `chip_smoke.py` both run this function.
"""

from __future__ import annotations

import random
import time
from contextlib import contextmanager

from ..bgg import BGGEncodingSampler, BGGPublicKeySampler
from ..circuit import PolyCircuit
from ..matrix import PolyMatrix
from ..ring.params import RingParams
from ..ring.poly import Poly
from ..sampler import TernaryDist, TrapdoorSampler, UniformSampler
from ..storage import init_storage_system, wait_for_all_writes
from . import PolyPltEvaluator, PublicLut
from .lwe import LWEBGGEncodingPltEvaluator, LWEBGGPubKeyPltEvaluator

P_MOD = 7
ERROR_SIGMA = 4.0
TRAPDOOR_SIGMA = 4.578
KEY = bytes([0x13, 0x37, 0xC0, 0xDE] * 8)


def modp_chain_circuit(params: RingParams, p: int, lookups: int) -> PolyCircuit:
    """acc = x0; acc = LUT_mod_p(acc * x_i) for i = 1..lookups."""
    circuit = PolyCircuit()
    inputs = circuit.input(lookups + 1)
    lut = PublicLut.from_dict(params, {x: (x, x % p) for x in range(p * p)})
    lut_id = circuit.register_public_lut(lut)
    acc = inputs[0]
    for wire in inputs[1:]:
        acc = circuit.public_lookup_gate(circuit.mul_gate(acc, wire), lut_id)
    circuit.output([acc])
    return circuit


def run_lwe_modp_chain(ring: tuple[int, int, int, int], workdir, *,
                       lookups: int = 2, mesh=None) -> dict:
    """Run the chain on the ring (n, crt_depth, crt_bits, base_bits) with
    artifacts under `workdir` and decode its output.

    Raises AssertionError when the output does not decode to the plaintext.
    `mesh` shards the offline K_high preimage plane over all its devices.
    Returns {"error_bits", "phases_s"} (wall seconds per phase). The
    `params_tables` phase builds the host and device ring tables; it reads
    near zero when this process already built the same ring (`RingParams`
    instances are interned).
    """
    phases: dict[str, float] = {}

    @contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        phases[name] = time.perf_counter() - t0

    with phase("params_tables"):
        params = RingParams.new(*ring)
        params.jt.psi_rev_mont  # noqa: B018  (builds the device tables)
    q = params.modulus
    q_over_p = q // P_MOD
    circuit = modp_chain_circuit(params, P_MOD, lookups)

    rng = random.Random(4242)
    xs = [rng.randrange(P_MOD) for _ in range(lookups + 1)]
    expected = xs[0]
    for x in xs[1:]:
        expected = expected * x % P_MOD
    plaintexts = [Poly.const(params, v) for v in xs]

    d = 1
    with phase("sampling_keys"):
        pubkeys = BGGPublicKeySampler(KEY, d).sample(params, b"realistic", [True] * len(xs))
        us = UniformSampler(seed=99)
        secrets = [us.sample_poly(params, TernaryDist()) for _ in range(d)]
        es = BGGEncodingSampler(params, secrets, gauss_sigma=ERROR_SIGMA, seed=98)
        encodings = es.sample(params, pubkeys, plaintexts)
        trap = TrapdoorSampler(params, TRAPDOOR_SIGMA, seed=97)
        b0_trapdoor, b0_matrix = trap.trapdoor(params, d)
        b0_matrix.data.block_until_ready()

    init_storage_system(workdir)

    with phase("plaintext_oracle"):
        pt = circuit.eval(params, Poly.one(params), plaintexts,
                          plt_evaluator=PolyPltEvaluator())[0]
        if pt.const_coeff() != expected:
            raise AssertionError(f"plaintext oracle {pt.const_coeff()} != {expected}")

    with phase("offline_pubkey_circuit"):
        pk_eval = LWEBGGPubKeyPltEvaluator(KEY, trap, b0_matrix, b0_trapdoor,
                                           workdir, mesh=mesh)
        result_pubkey = circuit.eval(params, pubkeys[0], pubkeys[1:],
                                     plt_evaluator=pk_eval)

    with phase("offline_k_high_sampling"):
        pk_eval.sample_aux_matrices(params)
        wait_for_all_writes()

    with phase("online_encoding_circuit"):
        enc_eval = LWEBGGEncodingPltEvaluator(KEY, workdir, es.secret_vec @ b0_matrix)
        enc = circuit.eval(params, encodings[0], encodings[1:],
                           plt_evaluator=enc_eval)[0]

    with phase("decode"):
        if enc.plaintext.const_coeff() != expected:
            raise AssertionError("encoding plaintext differs from the oracle")
        if not enc.pubkey.matrix == result_pubkey[0].matrix:
            raise AssertionError("online A_LT differs from the offline one")
        s_times_pk = es.secret_vec @ enc.pubkey.matrix
        gadget = PolyMatrix.gadget_matrix(params, d)
        etg = (es.secret_vec @ gadget).mul_poly_scalar(enc.plaintext)
        diff = enc.vector - s_times_pk + etg
        coeff = int(diff.entry(0, 0).coeffs()[0])
        err = min(coeff, q - coeff)
        if err >= q_over_p // 2:
            raise AssertionError(f"error too large: {err.bit_length()} bits")
        rand_int = rng.randrange(P_MOD)
        rounded = (coeff + q_over_p * rand_int + q_over_p // 2) // q_over_p
        if rounded % P_MOD != rand_int:
            raise AssertionError("masked rounding decode failed")

    return {"error_bits": err.bit_length(), "phases_s": phases}
