"""ChaCha20 counter-mode PRNG with a full 256-bit keyspace, on raw key arrays.

Replacement for the reference's ChaCha20 CUDA device RNG
(/root/reference/cuda/src/ChaCha.cu:5-50) and the security backbone for every
keyed sampler: the round-1 build truncated SHA-256 digests to 8 bytes to seed
threefry2x32 (a 2^64 keyspace — ADVICE.md round-1 high finding). This module
keeps the entire 256-bit key as a plain uint32[8] array.

Implementation: RFC-8439 ChaCha20 block function vectorized over blocks; the
16-word state is [4 consts, 8 key words, 1 block counter, 3 nonce words]. The
three nonce words carry (counter_hi, stream word, purpose tag) so the
`random_bits` / `fold_in` / `split` streams can never collide. All arithmetic
is uint32 adds/xors/rotates — elementwise work that XLA fuses into a single
elementwise program per draw.

Design note: an earlier revision registered this impl through
`jax.extend.random.define_prng_impl` so `jax.random.*` worked on wrapped
keys. That path made XLA hang for minutes compiling even a 4-element draw
under `--xla_force_host_platform_device_count=8` (the typed-key array
machinery, not the chacha graph itself). The raw-array API here sidesteps the
key-array machinery entirely: callers hold uint32[8] arrays and call
`fold_in` / `split2` / `random_bits` / `normal` directly; everything inlines
into the surrounding jitted program.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

# Domain tags for the third nonce word (never reuse a (counter, nonce) pair
# across purposes under one key).
_DOMAIN_BITS = np.uint32(1)
_DOMAIN_FOLD = np.uint32(2)
_DOMAIN_SPLIT = np.uint32(3)
_DOMAIN_NORMAL = np.uint32(5)

_SIGMA = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

_N_ROUNDS = 20  # full ChaCha20, matching the reference CUDA RNG


def _rotl(x, n: int):
    return (x << n) | (x >> (32 - n))


def _quarter_round(s, a, b, c, d):
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = sa + sb
    sd = _rotl(sd ^ sa, 16)
    sc = sc + sd
    sb = _rotl(sb ^ sc, 12)
    sa = sa + sb
    sd = _rotl(sd ^ sa, 8)
    sc = sc + sd
    sb = _rotl(sb ^ sc, 7)
    s[a], s[b], s[c], s[d] = sa, sb, sc, sd


def _match_vma(arrays):
    """Promote every array to the union of the inputs' varying manual axes.

    Under `shard_map`, mixing shard-varying values (e.g. a key folded with
    `axis_index`) with invariant ones in a `fori_loop` carry fails typing;
    `pvary` on the invariant components fixes the carry. Outside shard_map
    every vma set is empty and this is the identity."""
    axes: set = set()
    for a in arrays:
        axes |= set(getattr(jax.typeof(a), "vma", ()))
    if not axes:
        return arrays
    out = []
    for a in arrays:
        missing = tuple(ax for ax in axes
                        if ax not in getattr(jax.typeof(a), "vma", ()))
        if missing:
            from ..parallel.mesh import pcast_varying
            a = pcast_varying(a, missing)
        out.append(a)
    return out


def _chacha_blocks(key8, counters, nonce0, nonce1, nonce2):
    """ChaCha20 keystream blocks.

    key8: uint32[8]; counters: uint32[nblocks]; nonce*: uint32 scalars (may be
    traced). Returns uint32[nblocks, 16].
    """
    nb = counters.shape[0]
    state = []
    for i in range(4):
        state.append(jnp.broadcast_to(jnp.uint32(int(_SIGMA[i])), (nb,)))
    for i in range(8):
        state.append(jnp.broadcast_to(key8[i], (nb,)))
    state.append(counters)
    for nw in (nonce0, nonce1, nonce2):
        state.append(jnp.broadcast_to(jnp.asarray(nw, jnp.uint32), (nb,)))
    init = tuple(_match_vma(state))

    # The rounds run under lax.fori_loop rather than unrolled: a fully
    # unrolled 20-round graph is ~1000 chained elementwise ops, which XLA:CPU
    # under --xla_force_host_platform_device_count=N compiles pathologically
    # slowly (minutes for a 4-element draw). The loop body is one double
    # round (~100 ops) compiled once; all blocks still vectorize across `nb`.
    def double_round(_, s):
        s = list(s)
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
        return tuple(s)

    state = jax.lax.fori_loop(0, _N_ROUNDS // 2, double_round, init)
    out = [s + i for s, i in zip(state, init)]
    return jnp.stack(out, axis=-1)


def _chacha_blocks_words_major(key8, counters, nonce0, nonce1, nonce2):
    """Same keystream as `_chacha_blocks` but stacked [16, nblocks] (word
    index MAJOR), so the large block axis is the minor one."""
    nb = counters.shape[0]
    state = []
    for i in range(4):
        state.append(jnp.broadcast_to(jnp.uint32(int(_SIGMA[i])), (nb,)))
    for i in range(8):
        state.append(jnp.broadcast_to(key8[i], (nb,)))
    state.append(counters)
    for nw in (nonce0, nonce1, nonce2):
        state.append(jnp.broadcast_to(jnp.asarray(nw, jnp.uint32), (nb,)))
    init = tuple(_match_vma(state))

    def double_round(_, s):
        s = list(s)
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
        return tuple(s)

    state = jax.lax.fori_loop(0, _N_ROUNDS // 2, double_round, init)
    out = [s + i for s, i in zip(state, init)]
    return jnp.stack(out, axis=0)


def _keystream_words(key8, nwords: int, domain: np.uint32):
    """uint32[nwords] of keystream under (key, domain).

    Word order is WORD-MAJOR across blocks (index = word*nblocks + block) so
    the big axis stays the minor one; any fixed deterministic order is
    equally uniform, and offline/online callers re-derive streams
    through this same function."""
    nblocks = -(-nwords // 16)
    counters = jnp.arange(nblocks, dtype=jnp.uint32)
    # nblocks is a static Python int; realistic draws keep it < 2^32, but
    # carry the high word anyway for safety.
    hi = int(nblocks >> 32)  # 0 for every realistic draw
    blocks = _chacha_blocks_words_major(key8, counters, np.uint32(hi), np.uint32(0), domain)
    return blocks.reshape(-1)[:nwords]


def _chacha_blocks_keys(keys, counters, nonce0, nonce1, nonce2):
    """ChaCha20 blocks with a PER-LANE key: keys uint32[nb, 8], counters
    uint32[nb]; nonce* scalars (or [nb]). Returns uint32[nb, 16].

    Lane i's block is bit-identical to `_chacha_blocks(keys[i],
    counters[i:i+1], ...)[0]` — the flat lane axis replaces nested `vmap`s of
    single-key blocks, which XLA:CPU compiles pathologically (a B=1000 nested
    vmap of the fori_loop did not finish compiling in 10 minutes; this flat
    form compiles once per shape and vectorizes across all lanes)."""
    nb = counters.shape[0]
    state = []
    for i in range(4):
        state.append(jnp.broadcast_to(jnp.uint32(int(_SIGMA[i])), (nb,)))
    for i in range(8):
        state.append(keys[:, i])
    state.append(counters)
    for nw in (nonce0, nonce1, nonce2):
        state.append(jnp.broadcast_to(jnp.asarray(nw, jnp.uint32), (nb,)))
    init = tuple(_match_vma(state))

    def double_round(_, s):
        s = list(s)
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
        return tuple(s)

    state = jax.lax.fori_loop(0, _N_ROUNDS // 2, double_round, init)
    out = [s + i for s, i in zip(state, init)]
    return jnp.stack(out, axis=-1)


def fold_in_batch(keys, datas) -> jax.Array:
    """Per-lane `fold_in`: keys uint32[nb, 8], datas uint32[nb] (< 2^32).
    Row i is bit-identical to `fold_in(keys[i], datas[i])`."""
    lo = jnp.asarray(datas, jnp.uint32)
    blk = _chacha_blocks_keys(keys, lo, np.uint32(0), np.uint32(0), _DOMAIN_FOLD)
    return blk[:, :8]


def keystream_words_batch(keys, nwords: int, domain) -> jax.Array:
    """uint32[nb, nwords]: row i is bit-identical to
    `_keystream_words(keys[i], nwords, domain)` (same word-major block
    order), computed as ONE flat-lane block call."""
    nb = keys.shape[0]
    nblocks = -(-nwords // 16)
    lane_keys = jnp.repeat(keys, nblocks, axis=0)  # [nb*nblocks, 8]
    counters = jnp.tile(jnp.arange(nblocks, dtype=jnp.uint32), (nb,))
    blocks = _chacha_blocks_keys(
        lane_keys, counters, np.uint32(0), np.uint32(0), jnp.asarray(domain, jnp.uint32)
    )  # [nb*nblocks, 16]
    w = blocks.reshape(nb, nblocks, 16)
    w = jnp.transpose(w, (0, 2, 1)).reshape(nb, nblocks * 16)  # word-major
    return w[:, :nwords]


def random_bits_batch(keys, shape: tuple, domain=None) -> jax.Array:
    """uint32[nb, *shape]: row i bit-identical to
    `random_bits(keys[i], shape, jnp.uint32)`."""
    n = math.prod(shape) if shape else 1
    words = keystream_words_batch(keys, n, _DOMAIN_BITS if domain is None else domain)
    return words.reshape((keys.shape[0],) + shape)


# ------------------------------------------------------------------ key API


def key_from_bytes(key_bytes: bytes) -> jax.Array:
    """Wrap a full 32-byte key as a uint32[8] key array (no entropy loss)."""
    assert len(key_bytes) == 32, "chacha key must be 32 bytes"
    return jnp.asarray(np.frombuffer(key_bytes, dtype="<u4"))


@jax.jit
def fold_in(key8, data) -> jax.Array:
    """New key = first 8 keystream words of block(counter=data_lo,
    nonce0=data_hi, domain FOLD). `data` may be a traced scalar (vmappable)."""
    d = jnp.asarray(data)
    if d.dtype.itemsize > 4:
        d64 = d.astype(jnp.uint64)
        lo = (d64 & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (d64 >> np.uint64(32)).astype(jnp.uint32)
    else:
        lo = d.view(jnp.uint32) if d.dtype == jnp.int32 else d.astype(jnp.uint32)
        hi = jnp.uint32(0)
    blk = _chacha_blocks(key8, lo.reshape(1), hi, np.uint32(0), _DOMAIN_FOLD)
    return blk[0, :8]


@functools.partial(jax.jit, static_argnames=("num",))
def split(key8, num: int = 2) -> jax.Array:
    """uint32[num, 8] of derived keys (domain SPLIT keystream)."""
    words = _keystream_words(key8, num * 8, _DOMAIN_SPLIT)
    return words.reshape(num, 8)


def split2(key8) -> tuple[jax.Array, jax.Array]:
    ks = split(key8, 2)
    return ks[0], ks[1]


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def random_bits(key8, shape: tuple, dtype=jnp.uint32) -> jax.Array:
    """Uniform random bits under (key, BITS domain)."""
    dtype = jnp.dtype(dtype)
    n = math.prod(shape) if shape else 1
    if dtype == jnp.uint64:
        words = _keystream_words(key8, 2 * n, _DOMAIN_BITS)
        w = words.astype(jnp.uint64)
        out = w[0::2] | (w[1::2] << np.uint64(32))
        return out.reshape(shape)
    if dtype == jnp.uint32:
        return _keystream_words(key8, n, _DOMAIN_BITS).reshape(shape)
    if dtype in (jnp.dtype(jnp.uint8), jnp.dtype(jnp.uint16)):
        bit_width = 8 if dtype == jnp.uint8 else 16
        per = 32 // bit_width
        nwords = -(-n // per)
        words = _keystream_words(key8, nwords, _DOMAIN_BITS)
        lanes = [
            (words >> np.uint32(bit_width * i)).astype(dtype)
            for i in range(per)
        ]
        flat = jnp.stack(lanes, axis=-1).reshape(-1)[:n]
        return flat.reshape(shape)
    raise ValueError(f"unsupported dtype {dtype}")


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def normal(key8, shape: tuple, dtype=jnp.float32) -> jax.Array:
    """Standard normals via Box-Muller over the NORMAL-domain keystream."""
    dtype = jnp.dtype(dtype)
    n = math.prod(shape) if shape else 1
    pairs = -(-n // 2)
    if dtype == jnp.dtype(jnp.float64):
        words = _keystream_words(key8, 4 * pairs, _DOMAIN_NORMAL)
        w = words.astype(jnp.uint64)
        u64 = w[0::2] | (w[1::2] << np.uint64(32))
        # (0, 1]: (x >> 11) spans [0, 2^53); +1 keeps log() finite
        u = ((u64 >> np.uint64(11)).astype(jnp.float64) + 1.0) * (2.0**-53)
        u1, u2 = u[:pairs], u[pairs:]
    else:
        words = _keystream_words(key8, 2 * pairs, _DOMAIN_NORMAL)
        u = (words.astype(jnp.float32) + 1.0) * (2.0**-32)
        u1, u2 = u[:pairs], u[pairs:]
    r = jnp.sqrt(-2.0 * jnp.log(u1)).astype(dtype)
    theta = (2.0 * np.pi) * u2.astype(dtype)
    z = jnp.concatenate([r * jnp.cos(theta), r * jnp.sin(theta)])
    return z[:n].reshape(shape).astype(dtype)


@functools.lru_cache(maxsize=1)
def _self_test_vector() -> bool:
    """RFC 8439 §2.3.2 test vector for the block function (host check)."""
    key = np.arange(32, dtype=np.uint8)
    key8 = jnp.asarray(key.view("<u4"))
    # RFC nonce = 00:00:00:09:00:00:00:4a:00:00:00:00, counter = 1
    blk = np.asarray(
        _chacha_blocks(
            key8,
            jnp.asarray([1], jnp.uint32),
            np.uint32(0x09000000),
            np.uint32(0x4A000000),
            np.uint32(0),
        )
    )[0]
    expected = np.array(
        [0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3,
         0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
         0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
         0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2],
        dtype=np.uint32,
    )
    return bool((blk == expected).all())
