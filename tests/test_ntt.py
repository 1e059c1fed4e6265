"""NTT + modular arithmetic kernel tests against Python-int ground truth."""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from mxx_tpu.ring.params import RingParams
from mxx_tpu.ring.ntt import ntt_fwd, ntt_inv, pointwise_mul
from mxx_tpu.utils.u32 import montmul, mulhi_u32, addmod, submod

from mxx_tpu.utils.numth import bit_reverse, find_primitive_2n_root

from reference_impl import negacyclic_mul, poly_eval


def rand_poly(rng, params):
    return np.stack(
        [rng.integers(0, q, size=params.n, dtype=np.uint64).astype(np.uint32) for q in params.moduli]
    )


def test_mulhi_u32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(mulhi_u32(jnp.asarray(a), jnp.asarray(b)))
    want = ((a.astype(np.uint64) * b.astype(np.uint64)) >> 32).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_montmul_exact():
    rng = np.random.default_rng(1)
    q = 1073479681  # 30-bit prime-ish value < 2^31, odd
    params_like_q = np.uint32(q)
    qinv = np.uint32((-pow(q, -1, 1 << 32)) % (1 << 32))
    a = rng.integers(0, q, size=2000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, q, size=2000, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(montmul(jnp.asarray(a), jnp.asarray(b), params_like_q, qinv))
    rinv = pow(1 << 32, -1, q)
    want = (a.astype(object) * b.astype(object) * rinv % q).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_addsubmod():
    rng = np.random.default_rng(2)
    q = np.uint32(97)
    a = rng.integers(0, 97, size=500, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 97, size=500, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(addmod(jnp.asarray(a), jnp.asarray(b), q)), (a + b) % 97
    )
    np.testing.assert_array_equal(
        np.asarray(submod(jnp.asarray(a), jnp.asarray(b), q)),
        (a.astype(np.int64) - b.astype(np.int64)) % 97,
    )


@pytest.mark.parametrize("n,depth,crt_bits", [(4, 2, 17), (16, 3, 20), (256, 2, 28), (1024, 1, 30)])
def test_ntt_roundtrip(n, depth, crt_bits):
    params = RingParams.new(n, depth, crt_bits, 1)
    rng = np.random.default_rng(3)
    x = rand_poly(rng, params)
    jt = params.jt
    y = ntt_fwd(jnp.asarray(x), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    z = ntt_inv(y, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg)
    np.testing.assert_array_equal(np.asarray(z), x)


@pytest.mark.parametrize("n,depth,crt_bits", [(4, 2, 17), (64, 2, 26), (128, 3, 29)])
def test_ntt_negacyclic_convolution(n, depth, crt_bits):
    params = RingParams.new(n, depth, crt_bits, 1)
    rng = np.random.default_rng(4)
    a = rand_poly(rng, params)
    b = rand_poly(rng, params)
    jt = params.jt
    fa = ntt_fwd(jnp.asarray(a), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    fb = ntt_fwd(jnp.asarray(b), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    fc = pointwise_mul(fa, fb, jt.moduli, jt.qinv_neg, jt.r2)
    c = np.asarray(ntt_inv(fc, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg))
    for t, q in enumerate(params.moduli):
        want = negacyclic_mul([int(v) for v in a[t]], [int(v) for v in b[t]], q)
        np.testing.assert_array_equal(c[t], np.array(want, dtype=np.uint32))


def test_ntt_batched_dims():
    params = RingParams.new(16, 2, 20, 1)
    rng = np.random.default_rng(5)
    jt = params.jt
    x = np.stack(
        [
            rng.integers(0, q, size=(3, 2, params.n), dtype=np.uint64).astype(np.uint32)
            for q in params.moduli
        ]
    )
    y = ntt_fwd(jnp.asarray(x), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    z = np.asarray(ntt_inv(y, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg))
    np.testing.assert_array_equal(z, x)
    # batched result matches per-element transform
    y0 = ntt_fwd(jnp.asarray(x[:, 1, 0]), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    np.testing.assert_array_equal(np.asarray(y)[:, 1, 0], np.asarray(y0))


def test_params_modulus_and_idempotents():
    params = RingParams.default()
    assert params.ring_dimension == 4 and params.crt_depth == 2
    for q in params.moduli:
        assert q % (2 * params.n) == 1
        assert q.bit_length() == 17
    assert len(set(params.moduli)) == 2
    for t, e in enumerate(params.crt_idempotents):
        for s, qs in enumerate(params.moduli):
            assert e % qs == (1 if s == t else 0)
    # reconstruction round-trip
    v = 12345678
    residues = [v % q for q in params.moduli]
    assert params.reconstruct_coeff(residues) == v % params.modulus


@pytest.mark.parametrize("n", [1 << 11, 1 << 13, 1 << 14])
def test_ntt_chain_large_rings(n):
    """The chain at the ring sizes the old fused plan took on a device: an
    exact round trip, and forward outputs against Python-int evaluation at
    psi^(2 bitrev(i) + 1) (EVAL slots are bit-reversed)."""
    params = RingParams.new(n, 2, 28, 14)
    jt = params.jt
    rng = np.random.default_rng(n)
    x = np.stack(
        [rng.integers(0, q, (2, n), dtype=np.uint64).astype(np.uint32) for q in params.moduli]
    )
    y = ntt_fwd(jnp.asarray(x), jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
    z = ntt_inv(y, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg)
    np.testing.assert_array_equal(np.asarray(z), x)
    y = np.asarray(y)
    for t, b, slot in zip(rng.integers(0, 2, 16), rng.integers(0, 2, 16), rng.integers(0, n, 16)):
        q = params.moduli[t]
        psi = find_primitive_2n_root(q, n)
        w = pow(psi, 2 * bit_reverse(int(slot), params.log_n) + 1, q)
        assert int(y[t, b, slot]) == poly_eval(x[t, b].tolist(), w, q)
