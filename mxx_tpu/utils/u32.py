"""32-bit modular arithmetic primitives (jnp, uint32).

All residues are stored in standard form in [0, q) with q < 2^31. 64-bit
products are built from 16-bit limb splits so every op is a 32-bit integer
multiply; Montgomery reduction (R = 2^32) avoids division.

This layer replaces the reference's OpenFHE native modular arithmetic and the
CUDA modmul helpers (/root/reference/cuda/src/matrix/MatrixArith.cu) with
vectorized jnp primitives.

Convention: data tensors carry a leading limb axis; per-limb constants are
passed as uint32 arrays of shape [L] and broadcast with `limb_bcast`.
"""

from __future__ import annotations

import jax.numpy as jnp

_M16 = 0xFFFF


def limb_bcast(c: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """Reshape a per-limb constant [L] for broadcasting against [L, ...]."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1))


def mulhi_u32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    a0 = a & _M16
    a1 = a >> 16
    b0 = b & _M16
    b1 = b >> 16
    lo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    hi = a1 * b1
    t = (lo >> 16) + (mid1 & _M16) + (mid2 & _M16)
    return hi + (mid1 >> 16) + (mid2 >> 16) + (t >> 16)


def mullo_u32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Low 32 bits of the product (native wrapping uint32 multiply)."""
    return a * b


def addmod(a: jnp.ndarray, b: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """(a + b) mod q, for a, b in [0, q), q < 2^31."""
    r = a + b
    return jnp.where(r >= q, r - q, r)


def submod(a: jnp.ndarray, b: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """(a - b) mod q, for a, b in [0, q)."""
    return jnp.where(a >= b, a - b, a + q - b)


def negmod(a: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(a == 0, a, q - a)


def montmul(a: jnp.ndarray, b: jnp.ndarray, q: jnp.ndarray, qinv_neg: jnp.ndarray) -> jnp.ndarray:
    """Montgomery product a * b * R^{-1} mod q with R = 2^32.

    qinv_neg = -q^{-1} mod 2^32. Requires a, b in [0, q), q odd, q < 2^31.
    Output in [0, q).
    """
    t_lo = a * b
    t_hi = mulhi_u32(a, b)
    m = t_lo * qinv_neg
    mq_hi = mulhi_u32(m, q)
    # t_lo + (m*q mod 2^32) == 0 mod 2^32 exactly; carry is 1 iff t_lo != 0.
    carry = (t_lo != 0).astype(jnp.uint32)
    r = t_hi + mq_hi + carry
    return jnp.where(r >= q, r - q, r)


def mulmod(
    a: jnp.ndarray,
    b: jnp.ndarray,
    q: jnp.ndarray,
    qinv_neg: jnp.ndarray,
    r2: jnp.ndarray,
) -> jnp.ndarray:
    """Plain a * b mod q for standard-form operands (two Montgomery steps).

    r2 = R^2 mod q. Prefer `montmul(a, b_mont)` with a pre-lifted constant
    when b is reused.
    """
    return montmul(montmul(a, b, q, qinv_neg), r2, q, qinv_neg)


def to_mont(a: jnp.ndarray, q: jnp.ndarray, qinv_neg: jnp.ndarray, r2: jnp.ndarray) -> jnp.ndarray:
    """Lift standard-form a to Montgomery form a*R mod q."""
    return montmul(a, r2, q, qinv_neg)


def from_mont(a: jnp.ndarray, q: jnp.ndarray, qinv_neg: jnp.ndarray) -> jnp.ndarray:
    """Lower Montgomery-form a*R to standard form a (montmul by 1)."""
    one = jnp.ones((), dtype=jnp.uint32)
    return montmul(a, one, q, qinv_neg)


def mod_u64_pair(hi: jnp.ndarray, lo: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """(hi * 2^32 + lo) mod q via uint64 (requires x64 mode). q < 2^31."""
    v = (hi.astype(jnp.uint64) << 32) | lo.astype(jnp.uint64)
    return (v % q.astype(jnp.uint64)).astype(jnp.uint32)
