"""Exact Z_q polynomial-matrix multiply via balanced int8 digits.

Replacement for the reference's tiled CUDA eval-domain matmul
(/root/reference/cuda/src/matrix/MatrixArith.cu:191-260). Each uint32 residue
(q < 2^30) is split into four balanced base-256 digits in [-128, 127]; the
16 digit-plane products run as s8 x s8 -> s32 batched `dot_general`s, then
the seven digit-diagonal planes are recombined mod q elementwise with
Montgomery multiplies by 2^{8s}.

Exactness: |digit| <= 128, so a plane accumulation over K terms is bounded by
4 * 128^2 * K < 2^31 for K <= 32768 — no overflow, bit-exact results.

Shapes: a uint32[L, r, k, n], b uint32[L, k, c, n], both in EVAL format;
result uint32[L, r, c, n].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.u32 import addmod, montmul, submod

MAX_CONTRACT = 32768


def _balanced_digits_i8(x: jnp.ndarray) -> list[jnp.ndarray]:
    """Split uint32 values < 2^30 into 4 balanced base-256 int8 digits."""
    v = x.astype(jnp.int32)
    planes = []
    for _ in range(3):
        d = ((v + 128) & 255) - 128
        planes.append(d.astype(jnp.int8))
        v = (v - d) >> 8
    planes.append(v.astype(jnp.int8))  # final digit in [0, 66]
    return planes


@jax.jit
def zq_matmul(a, b, q, qinv_neg, combine_pows_mont, sign_corr_pows):
    """Exact (a @ b) mod q, batched per (limb, eval-slot).

    a: uint32[L, r, k, n], b: uint32[L, k, c, n] -> uint32[L, r, c, n].
    """
    L, r, k, n = a.shape
    _, _, c, _ = b.shape
    assert b.shape == (L, k, c, n), (a.shape, b.shape)
    assert k <= MAX_CONTRACT, f"contraction dim {k} exceeds exactness bound"

    # [L, r, k, n] -> [L, n, r, k]; [L, k, c, n] -> [L, n, k, c]
    at = jnp.transpose(a, (0, 3, 1, 2))
    bt = jnp.transpose(b, (0, 3, 1, 2))
    a_planes = _balanced_digits_i8(at)
    b_planes = _balanced_digits_i8(bt)

    dn = (((3,), (2,)), ((0, 1), (0, 1)))  # contract k; batch (L, n)
    plane_sums = [None] * 7
    for i in range(4):
        for j in range(4):
            p = lax.dot_general(a_planes[i], b_planes[j], dn, preferred_element_type=jnp.int32)
            s = i + j
            plane_sums[s] = p if plane_sums[s] is None else plane_sums[s] + p

    qb = q.reshape(L, 1, 1, 1)
    qib = qinv_neg.reshape(L, 1, 1, 1)
    acc = jnp.zeros((L, n, r, c), dtype=jnp.uint32)
    for s in range(7):
        p = plane_sums[s]
        u = p.astype(jnp.uint32)
        neg = p < 0
        pos_part = montmul(u, combine_pows_mont[s].reshape(L, 1, 1, 1), qb, qib)
        corr = sign_corr_pows[s].reshape(L, 1, 1, 1)
        term = jnp.where(neg, submod(pos_part, jnp.broadcast_to(corr, pos_part.shape), qb), pos_part)
        acc = addmod(acc, term, qb)

    return jnp.transpose(acc, (0, 2, 3, 1))  # [L, r, c, n]
