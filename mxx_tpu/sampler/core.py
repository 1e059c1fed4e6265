"""Core jitted sampling kernels: counter-based keyed PRNG -> residue planes.

Replacement for the reference's Keccak rejection hash sampler
(/root/reference/src/sampler/hash.rs:14-51), OpenFHE DUG/DGG/BUG/TUG
generators (src/sampler/uniform.rs) and the ChaCha CUDA RNG
(cuda/src/ChaCha.cu). Design:

- Randomness is derived from a 256-bit key + tag via SHA-256 -> 256-bit
  ChaCha20 device key (chacha.py; full digest kept — no keyspace truncation);
  each conceptual matrix column gets `fold_in(key, col)`, so any column
  window regenerates bit-identically without communication — preserving the
  reference's `sample_hash_columns` window-exactness property
  (src/sampler/mod.rs:48-70).
- Uniform mod q_t uses a 96-bit draw reduced mod q_t (statistical distance
  < 2^-65 per sample) instead of rejection — fixed trip count, jit-friendly.
- Discrete Gaussians: exact CDF inversion over a u64 threshold table for
  sigma <= 300 (table tail 5e-32 like the reference's Peikert table,
  trapdoor/sampler.rs:110-131); rounded continuous Gaussian above
  (the reference switches to Karney there; rounding is statistically close
  at that scale and fully vectorizes).
"""

from __future__ import annotations

import functools
import hashlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import chacha

KARNEY_THRESHOLD = 300.0
_GAUSS_TABLE_ACC = 5e-32


def derive_key_bytes(key: bytes, tag: bytes | str, domain: bytes = b"") -> bytes:
    """Host-side digest for `derive_key` (batch callers stack these into one
    device upload instead of paying a device_put per tag)."""
    if isinstance(tag, str):
        tag = tag.encode()
    return hashlib.sha256(b"mxx_tpu/v1" + bytes(key) + b"|" + tag + b"|" + domain).digest()


def derive_key(key: bytes, tag: bytes | str, domain: bytes = b"") -> jax.Array:
    """Derive a device PRNG key from a 32-byte key + tag (+ domain separator).

    The full SHA-256 digest becomes a 256-bit ChaCha20 key (see chacha.py) —
    no entropy is discarded, matching the reference's Keccak sampler keyed by
    the entire 32-byte hash_key (src/sampler/hash.rs:14-51)."""
    return chacha.key_from_bytes(derive_key_bytes(key, tag, domain))


def fresh_key(seed: int | bytes | None = None) -> jax.Array:
    """256-bit-keyspace device key: from OS entropy when seed is None, else
    deterministically from the seed (tests / reproducible artifacts)."""
    if seed is None:
        material = os.urandom(32)
    elif isinstance(seed, bytes):
        material = hashlib.sha256(b"mxx_tpu/fresh" + seed).digest()
    else:
        material = hashlib.sha256(
            b"mxx_tpu/fresh" + int(seed).to_bytes(16, "little", signed=True)
        ).digest()
    return chacha.key_from_bytes(material)


@functools.lru_cache(maxsize=64)
def gauss_table(sigma: float) -> tuple[np.ndarray, int]:
    """u64 CDF thresholds for the discrete Gaussian D_{Z,sigma}, tail-cut at
    ~12 sigma (acc 5e-32, matching the reference's inversion table)."""
    m = math.sqrt(-2.0 * math.log(_GAUSS_TABLE_ACC))
    fin = max(1, math.ceil(sigma * m))
    xs = np.arange(-fin, fin + 1, dtype=np.float64)
    logp = -(xs * xs) / (2.0 * sigma * sigma)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    cum = np.cumsum(p)
    thresholds = np.array(
        [min(int(c * 2**64), 2**64 - 1) for c in cum], dtype=np.uint64
    )
    return thresholds, fin


@functools.partial(jax.jit, static_argnames=("shape",))
def uniform_residues(key, shape: tuple, q):
    """Uniform in [0, q_t) per limb: returns uint32[L, *shape]."""
    L = q.shape[0]
    bits = chacha.random_bits(key, (3, L) + shape, jnp.uint32)
    q64 = q.reshape((L,) + (1,) * len(shape)).astype(jnp.uint64)
    r = bits[0].astype(jnp.uint64) % q64
    r = ((r << 32) | bits[1].astype(jnp.uint64)) % q64
    r = ((r << 32) | bits[2].astype(jnp.uint64)) % q64
    return r.astype(jnp.uint32)


def uniform_residues_batch(keys, shape: tuple, q):
    """Per-lane `uniform_residues`: keys uint32[nb, 8] -> uint32[nb, L,
    *shape], row i bit-identical to `uniform_residues(keys[i], shape, q)`.
    Flat lane-parallel ChaCha (see chacha._chacha_blocks_keys) — nested vmaps
    of the single-key kernel are an XLA:CPU compile hazard."""
    nb = keys.shape[0]
    L = q.shape[0]
    bits = chacha.random_bits_batch(keys, (3, L) + shape)  # [nb, 3, L, *shape]
    q64 = q.reshape((1, L) + (1,) * len(shape)).astype(jnp.uint64)
    r = bits[:, 0].astype(jnp.uint64) % q64
    r = ((r << 32) | bits[:, 1].astype(jnp.uint64)) % q64
    r = ((r << 32) | bits[:, 2].astype(jnp.uint64)) % q64
    return r.astype(jnp.uint32)


def _int_to_residues(v, q):
    """Signed int64 values -> uint32 residues per limb. v: [*shape], q: [L]."""
    L = q.shape[0]
    q64 = q.reshape((L,) + (1,) * v.ndim).astype(jnp.int64)
    vv = v[None].astype(jnp.int64) % q64  # python-style mod: result in [0, q)
    return vv.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("shape",))
def bit_residues(key, shape: tuple, q):
    b = (chacha.random_bits(key, shape, jnp.uint32) & 1).astype(jnp.int64)
    return _int_to_residues(b, q)


@functools.partial(jax.jit, static_argnames=("shape",))
def ternary_residues(key, shape: tuple, q):
    # unbiased via 2^32 mod 3 == 1: rejection-free masked draw
    u = chacha.random_bits(key, shape, jnp.uint32)
    t = (u % 3).astype(jnp.int64) - 1
    return _int_to_residues(t, q)


@functools.partial(jax.jit, static_argnames=("shape", "tail"))
def gauss_residues_table(key, shape: tuple, q, thresholds, tail: int):
    u = chacha.random_bits(key, shape, jnp.uint64)
    idx = jnp.searchsorted(thresholds, u, side="right")
    v = idx.astype(jnp.int64) - tail
    return _int_to_residues(v, q)


@functools.partial(jax.jit, static_argnames=("shape",))
def gauss_residues_rounded(key, shape: tuple, q, sigma):
    x = chacha.normal(key, shape, jnp.float64) * sigma
    v = jnp.round(x).astype(jnp.int64)
    return _int_to_residues(v, q)


def gauss_residues(key, shape: tuple, q, sigma: float):
    if sigma <= KARNEY_THRESHOLD:
        thresholds, tail = gauss_table(float(sigma))
        return gauss_residues_table(key, shape, q, jnp.asarray(thresholds), tail)
    return gauss_residues_rounded(key, shape, q, float(sigma))


def gauss_ints(key, shape: tuple, sigma: float):
    """Signed int64 discrete-Gaussian draws (no residue reduction)."""
    if sigma <= KARNEY_THRESHOLD:
        thresholds, tail = gauss_table(float(sigma))
        u = chacha.random_bits(key, shape, jnp.uint64)
        idx = jnp.searchsorted(jnp.asarray(thresholds), u, side="right")
        return idx.astype(jnp.int64) - tail
    x = chacha.normal(key, shape, jnp.float64) * float(sigma)
    return jnp.round(x).astype(jnp.int64)
