"""Negacyclic NTT over CRT limbs (vectorized jnp radix-4 stage chain).

Replacement for the reference's CUDA NTT kernels
(/root/reference/cuda/src/matrix/MatrixNTT.cu:39-152) and OpenFHE's CPU NTT.
Uses the merged-twist algorithm (Longa-Naehrig 2016): the psi twist is folded
into bit-reversed twiddle tables, so the forward transform maps natural-order
coefficients to bit-reversed-order evaluations ("EVAL" format) and the inverse
maps back; pointwise products in EVAL realize negacyclic convolution. EVAL
slot i holds the evaluation at psi^(2 * bitrev(i) + 1).

Shapes: x is uint32[L, ..., n] (any number of middle dims); twiddle tables are
uint32[L, n] in Montgomery form; per-limb constants are uint32[L]. Batches are
flattened to [L, P, n] before the stage chain, so every stage is one 3-D
elementwise pass that XLA fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.u32 import addmod, montmul, submod


def _bc(c: jnp.ndarray, ndim: int, extra_dims: int = 0) -> jnp.ndarray:
    """Broadcast per-limb const [L] against [L, ...] with `ndim`+extra dims."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1 + extra_dims))


def _fwd_stages(x, psi_rev_mont, q, qinv_neg):
    """Forward stage chain on [L, P, n]: radix-4 (two merged radix-2 levels
    per memory pass — same montmul count, half the memory traffic), with one
    leading radix-2 stage when log2(n) is odd."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nd = x.ndim
    L = x.shape[0]
    qb = _bc(q, nd, 1)
    qib = _bc(qinv_neg, nd, 1)
    m = 1

    def wslice(lo, hi, blocks):
        return psi_rev_mont[:, lo:hi].reshape((L,) + (1,) * (nd - 2) + (blocks, 1))

    if (n.bit_length() - 1) % 2 == 1:
        t = n // 2
        v = x.reshape(lead + (1, 2, t))
        a = v[..., 0, :]
        b = v[..., 1, :]
        wb = montmul(b, wslice(1, 2, 1), qb, qib)
        x = jnp.stack((addmod(a, wb, qb), submod(a, wb, qb)), axis=-2).reshape(lead + (n,))
        m = 2
    while m < n:
        t = n // (4 * m)
        v = x.reshape(lead + (m, 2, 2, t))
        a0 = v[..., 0, 0, :]
        a1 = v[..., 0, 1, :]
        b0 = v[..., 1, 0, :]
        b1 = v[..., 1, 1, :]
        w1 = wslice(m, 2 * m, m)  # psi[m+j], level-1 twiddle per block j
        w2 = psi_rev_mont[:, 2 * m : 4 * m].reshape(
            (L,) + (1,) * (nd - 2) + (m, 2, 1)
        )
        w20 = w2[..., 0, :]  # psi[2m + 2j]
        w21 = w2[..., 1, :]  # psi[2m + 2j + 1]
        wb0 = montmul(b0, w1, qb, qib)
        wb1 = montmul(b1, w1, qb, qib)
        t0_ = addmod(a0, wb0, qb)
        t1_ = addmod(a1, wb1, qb)
        u0 = submod(a0, wb0, qb)
        u1 = submod(a1, wb1, qb)
        s1 = montmul(t1_, w20, qb, qib)
        s2 = montmul(u1, w21, qb, qib)
        x = jnp.stack(
            (
                addmod(t0_, s1, qb),
                submod(t0_, s1, qb),
                addmod(u0, s2, qb),
                submod(u0, s2, qb),
            ),
            axis=-2,
        ).reshape(lead + (n,))
        m *= 4
    return x


def _inv_stages(x, psi_inv_rev_mont, n_inv_mont, q, qinv_neg):
    """Inverse stage chain on [L, P, n]: merged radix-4 Gentleman-Sande pairs
    (half the passes), trailing radix-2 stage when log2(n) is odd."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nd = x.ndim
    L = x.shape[0]
    qb = _bc(q, nd, 1)
    qib = _bc(qinv_neg, nd, 1)
    t = 1
    m = n
    while m >= 4:
        h = m // 2
        h2 = m // 4
        v = x.reshape(lead + (h2, 2, 2, t))
        u0 = v[..., 0, 0, :]
        w0 = v[..., 0, 1, :]
        u1 = v[..., 1, 0, :]
        w1_ = v[..., 1, 1, :]
        tw1 = psi_inv_rev_mont[:, h : 2 * h].reshape(
            (L,) + (1,) * (nd - 2) + (h2, 2, 1)
        )
        tw1e = tw1[..., 0, :]  # psi_inv[h + 2k]
        tw1o = tw1[..., 1, :]  # psi_inv[h + 2k + 1]
        tw2 = psi_inv_rev_mont[:, h2 : 2 * h2].reshape(
            (L,) + (1,) * (nd - 2) + (h2, 1)
        )
        a_ = addmod(u0, w0, qb)
        b_ = montmul(submod(u0, w0, qb), tw1e, qb, qib)
        c_ = addmod(u1, w1_, qb)
        d_ = montmul(submod(u1, w1_, qb), tw1o, qb, qib)
        x = jnp.stack(
            (
                jnp.stack((addmod(a_, c_, qb), addmod(b_, d_, qb)), axis=-2),
                jnp.stack(
                    (
                        montmul(submod(a_, c_, qb), tw2, qb, qib),
                        montmul(submod(b_, d_, qb), tw2, qb, qib),
                    ),
                    axis=-2,
                ),
            ),
            axis=-3,
        ).reshape(lead + (n,))
        t *= 4
        m = h2
    if m == 2:
        v = x.reshape(lead + (1, 2, t))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        tw = psi_inv_rev_mont[:, 1:2].reshape((L,) + (1,) * (nd - 2) + (1, 1))
        x = jnp.stack(
            (addmod(u, w_, qb), montmul(submod(u, w_, qb), tw, qb, qib)), axis=-2
        ).reshape(lead + (n,))
    return montmul(x, _bc(n_inv_mont, nd), _bc(q, nd), _bc(qinv_neg, nd))


def _flat(stages, x, *tables):
    """Apply a stage chain over [L, ..., n] on the flattened [L, P, n] view."""
    L, n = x.shape[0], x.shape[-1]
    return stages(x.reshape(L, -1, n), *tables).reshape(x.shape)


@jax.jit
def ntt_fwd(x, psi_rev_mont, q, qinv_neg):
    """Forward negacyclic NTT along the last axis (natural -> bit-reversed)."""
    return _flat(_fwd_stages, x, psi_rev_mont, q, qinv_neg)


@jax.jit
def ntt_inv(x, psi_inv_rev_mont, n_inv_mont, q, qinv_neg):
    """Inverse negacyclic NTT along the last axis (bit-reversed -> natural)."""
    return _flat(_inv_stages, x, psi_inv_rev_mont, n_inv_mont, q, qinv_neg)


@jax.jit
def pointwise_mul(a, b, q, qinv_neg, r2):
    """Exact a*b mod q for standard-form operands (elementwise)."""
    qb = _bc(q, a.ndim)
    qib = _bc(qinv_neg, a.ndim)
    return montmul(montmul(a, b, qb, qib), _bc(r2, a.ndim), qb, qib)
