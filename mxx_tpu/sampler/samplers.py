"""Matrix samplers over the keyed PRNG core.

- `HashSampler`: deterministic matrices from (key, tag) with bit-exact column
  windows (reference `PolyHashSampler`, src/sampler/mod.rs:28-126 and
  src/sampler/hash.rs) — shard-local regeneration of pseudorandom matrices is
  communication-free by construction.
- `UniformSampler`: fresh randomness (reference `PolyUniformSampler`,
  src/sampler/uniform.rs) from a host-held splitting key.
"""

from __future__ import annotations

import os
import struct

import jax
import jax.numpy as jnp

from ..matrix import PolyMatrix
from ..ring.params import RingParams
from ..ring.poly import COEFF, Poly
from . import chacha, core
from .dist import BitDist, DistType, FinRingDist, GaussDist, TernaryDist


def _dist_domain(dist: DistType) -> bytes:
    if isinstance(dist, FinRingDist):
        return b"finring"
    if isinstance(dist, GaussDist):
        return b"gauss" + struct.pack("<d", dist.sigma)
    if isinstance(dist, BitDist):
        return b"bit"
    if isinstance(dist, TernaryDist):
        return b"ternary"
    raise TypeError(dist)


def _sample_residues(key, dist: DistType, shape: tuple, q) -> jnp.ndarray:
    """Draw residue planes uint32[L, *shape] for the given distribution."""
    if isinstance(dist, FinRingDist):
        return core.uniform_residues(key, shape, q)
    if isinstance(dist, GaussDist):
        return core.gauss_residues(key, shape, q, dist.sigma)
    if isinstance(dist, BitDist):
        return core.bit_residues(key, shape, q)
    if isinstance(dist, TernaryDist):
        return core.ternary_residues(key, shape, q)
    raise TypeError(dist)


import functools


@functools.partial(jax.jit, static_argnames=("dist", "nrow", "n"))
def _columns_planes(base_key, cols_arr, q, dist: DistType, nrow: int, n: int):
    ncol = cols_arr.shape[0]
    if isinstance(dist, (FinRingDist, BitDist, TernaryDist)):
        # flat lane-parallel path (see _batch_columns_planes): per-column
        # bit-identical to fold_in + _sample_residues
        col_keys = chacha.fold_in_batch(
            jnp.broadcast_to(base_key, (ncol, 8)), cols_arr
        )
        if isinstance(dist, FinRingDist):
            planes = core.uniform_residues_batch(col_keys, (nrow, n), q)
        elif isinstance(dist, BitDist):
            b = (chacha.random_bits_batch(col_keys, (nrow, n)) & 1).astype(jnp.int64)
            planes = _int_to_residues_batch(b, q)
        else:
            u = chacha.random_bits_batch(col_keys, (nrow, n))
            planes = _int_to_residues_batch((u % 3).astype(jnp.int64) - 1, q)
        return jnp.transpose(planes, (1, 2, 0, 3))  # [L, nrow, ncol, n]

    def one_col(j):
        k = chacha.fold_in(base_key, j)
        return _sample_residues(k, dist, (nrow, n), q)  # [L, nrow, n]

    planes = jax.vmap(one_col)(cols_arr)  # [ncol, L, nrow, n]
    return jnp.transpose(planes, (1, 2, 0, 3))  # [L, nrow, ncol, n]


@functools.partial(jax.jit, static_argnames=("dist", "nrow", "n", "ncol"))
def _batch_columns_planes(base_keys, q, dist: DistType, nrow: int, n: int, ncol: int):
    """Many (key, full column range) matrices in ONE program: per-key output
    bit-identical to `_columns_planes` (same fold_in / per-column streams),
    computed over a FLAT (key, col) lane axis. The previous nested
    vmap(vmap(fori_loop)) form was an XLA:CPU compile hazard — a B=1000
    batch did not finish compiling in 10 minutes; this form compiles in
    seconds and vectorizes across all B*ncol lanes."""
    B = base_keys.shape[0]
    cols = jnp.tile(jnp.arange(ncol, dtype=jnp.uint32), (B,))  # [B*ncol]
    keys_rep = jnp.repeat(base_keys, ncol, axis=0)  # [B*ncol, 8]
    col_keys = chacha.fold_in_batch(keys_rep, cols)  # [B*ncol, 8]
    if isinstance(dist, FinRingDist):
        planes = core.uniform_residues_batch(col_keys, (nrow, n), q)
    elif isinstance(dist, BitDist):
        b = (chacha.random_bits_batch(col_keys, (nrow, n)) & 1).astype(jnp.int64)
        planes = _int_to_residues_batch(b, q)
    elif isinstance(dist, TernaryDist):
        u = chacha.random_bits_batch(col_keys, (nrow, n))
        planes = _int_to_residues_batch((u % 3).astype(jnp.int64) - 1, q)
    else:
        # Gauss batches fall back to per-lane vmap of the table sampler
        # (cold path: offline Gauss planes use the trapdoor samplers instead)
        planes = jax.vmap(lambda k: _sample_residues(k, dist, (nrow, n), q))(col_keys)
    planes = planes.reshape(B, ncol, q.shape[0], nrow, n)
    return jnp.transpose(planes, (0, 2, 3, 1, 4))  # [B, L, nrow, ncol, n]


def _int_to_residues_batch(v, q):
    """Signed int64 [nb, *shape] -> uint32 residues [nb, L, *shape]."""
    L = q.shape[0]
    q64 = q.reshape((1, L) + (1,) * (v.ndim - 1)).astype(jnp.int64)
    return (v[:, None].astype(jnp.int64) % q64).astype(jnp.uint32)


def _columns_matrix(params: RingParams, base_key, dist: DistType, nrow: int, cols) -> PolyMatrix:
    """Sample columns [col][L, nrow, n] via per-column fold_in; stack to a matrix.

    The inner program is jitted (keyed on dist/nrow/ncol/n) — hash sampling is
    called per LUT gate and per protocol artifact, so per-call retracing of
    the ChaCha rounds would dominate protocol runtime."""
    cols_arr = jnp.asarray(cols, dtype=jnp.uint32)
    data = _columns_planes(base_key, cols_arr, params.jt.moduli, dist, nrow, params.n)
    return PolyMatrix(data, COEFF, params)


class HashSampler:
    """Deterministic keyed sampler with exact column windows."""

    def sample_hash(
        self, params: RingParams, key: bytes, tag, nrow: int, ncol: int, dist: DistType
    ) -> PolyMatrix:
        return self.sample_hash_columns(params, key, tag, nrow, ncol, 0, ncol, dist)

    def sample_hash_columns(
        self,
        params: RingParams,
        key: bytes,
        tag,
        nrow: int,
        total_ncol: int,
        col_start: int,
        col_len: int,
        dist: DistType,
    ) -> PolyMatrix:
        assert col_start + col_len <= total_ncol, "column window out of bounds"
        base = core.derive_key(key, tag, domain=_dist_domain(dist))
        return _columns_matrix(params, base, dist, nrow, range(col_start, col_start + col_len))

    def sample_hash_batch(
        self, params: RingParams, key: bytes, tags: list, nrow: int, ncol: int,
        dist: DistType, eval_form: bool = False,
    ) -> list[PolyMatrix]:
        """sample_hash for many tags in ONE device program (the offline
        planes derive one K_low per LUT entry, so one dispatch replaces one per
        tag). Bit-identical to per-tag calls.

        Keys are derived host-side and shipped as ONE array; results come
        back in ONE host fetch and are returned as zero-copy numpy views
        (batch callers previously paid a device dispatch per tag for key
        upload and per matrix for slicing — round-3 profile). With
        `eval_form=True` the whole batch is NTT'd in the same program and
        EVAL-form matrices are returned (for consumers that immediately
        to_eval(), e.g. batched LUT output pubkeys)."""
        import numpy as np

        from ..ring.ntt import ntt_fwd
        from ..ring.poly import EVAL

        domain = _dist_domain(dist)
        base_np = np.stack([
            np.frombuffer(core.derive_key_bytes(key, tag, domain), dtype="<u4")
            for tag in tags
        ])
        B = len(tags)
        fmt = EVAL if eval_form else COEFF
        out = []
        # Chunk at <= 4096 and pad each chunk to a power of two (repeat the
        # last key): per-level batch widths vary freely and every fresh width
        # was a fresh XLA compile; pow2 buckets capped at 4096 bound the
        # compiled shape set to ~8 variants.
        CH = 4096
        for start in range(0, B, CH):
            chunk = base_np[start : start + CH]
            nb = chunk.shape[0]
            pad = 1
            while pad < nb:
                pad *= 2
            if pad != nb:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad - nb, axis=0)])
            data = _batch_columns_planes(
                jnp.asarray(chunk), params.jt.moduli, dist, nrow, params.n, ncol
            )
            if eval_form:
                L = params.crt_depth
                # [P, L, r, c, n] -> [L, P*r, c, n] for one batched NTT (still
                # padded, so the NTT shape stays a pow2 bucket too)
                flat = jnp.transpose(data, (1, 0, 2, 3, 4)).reshape(
                    L, pad * nrow, ncol, params.n
                )
                flat = ntt_fwd(
                    flat, params.jt.psi_rev_mont, params.jt.moduli, params.jt.qinv_neg
                )
                data = jnp.transpose(
                    flat.reshape(L, pad, nrow, ncol, params.n), (1, 0, 2, 3, 4)
                )
            host = np.asarray(data)[:nb]  # one fetch; slices below are views
            out.extend(PolyMatrix(host[i], fmt, params) for i in range(nb))
        return out

    def sample_hash_decomposed(self, params, key, tag, nrow, ncol, dist) -> PolyMatrix:
        return self.sample_hash(params, key, tag, nrow, ncol, dist).decompose()

    def sample_hash_decomposed_columns(
        self, params, key, tag, nrow, total_ncol, col_start, col_len, dist
    ) -> PolyMatrix:
        return self.sample_hash_columns(
            params, key, tag, nrow, total_ncol, col_start, col_len, dist
        ).decompose()

    def sample_hash_small_decomposed(self, params, key, tag, nrow, ncol, dist) -> PolyMatrix:
        return self.sample_hash(params, key, tag, nrow, ncol, dist).small_decompose()


class UniformSampler:
    """Fresh-randomness sampler; host-held key split per call."""

    def __init__(self, seed: int | None = None):
        # 256-bit ChaCha key: OS entropy when unseeded (ADVICE round-1 fix —
        # secrets must not be derived from a 64-bit keyspace).
        self._key = core.fresh_key(seed)

    def _next_key(self):
        self._key, sub = chacha.split2(self._key)
        return sub

    def sample_uniform(
        self, params: RingParams, nrow: int, ncol: int, dist: DistType
    ) -> PolyMatrix:
        q = params.jt.moduli
        planes = _sample_residues(self._next_key(), dist, (nrow, ncol, params.n), q)
        return PolyMatrix(planes, COEFF, params)

    def sample_poly(self, params: RingParams, dist: DistType) -> Poly:
        return self.sample_uniform(params, 1, 1, dist).entry(0, 0)
