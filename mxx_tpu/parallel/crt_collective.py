"""CRT-reconstruction collective over a sharded limb axis.

SURVEY.md §2.7 P9: the decode / modulus-switch step needs the big integer
x = sum_t r_t e_t (mod q) reconstructed from per-limb residues that live on
different devices. Materializing x is impossible in u32 device arithmetic, so
the collective computes the thing protocols actually consume at scale:

    v = round(x * P / q) mod P          (scale-and-round to a small modulus)

which decomposes into per-limb contributions that psum across devices:

    e_t * P / q = I_t + f_t  (integer and fractional part, host precomputed)
    v = ( sum_t [r_t * I_t mod P]  +  round(sum_t r_t * f_t) ) mod P

Each device computes its local limbs' integer contribution (exact, mod P) and
fractional contribution (float64), one `psum` each over the limb axis, then a
cheap combine. Decode-at-scale = crt_switch_sharded to P = 2^k followed by
the usual high-bit comparison. Exactness matches PolyMatrix.modulus_switch
(same float64 approximation OpenFHE's ScaleAndRound uses).

Reference analog: the reference is single-node and reconstructs on the host
(src/poly/mod.rs:44-78 reconst_coeffs); this module is its multi-chip design.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from .mesh import LIMB_AXIS


def _ms_parts(params, new_modulus: int):
    """Host tables: (I_t mod P as uint32[L], f_t as float64[L])."""
    q = params.modulus
    ints, fracs = [], []
    for e in params.crt_idempotents:
        num = e * new_modulus
        ints.append((num // q) % new_modulus)
        fracs.append(float((num % q) / q))
    return (
        np.array(ints, dtype=np.uint64),
        np.array(fracs, dtype=np.float64),
    )


def crt_switch_sharded(params, data, new_modulus: int, mesh, *,
                       limb_axis: str = LIMB_AXIS):
    """round(x * P / q) mod P per coefficient, with the limb axis of `data`
    sharded over `mesh`'s `limb_axis`.

    data: uint32[L, ...] COEFF-form residues (any trailing shape).
    Returns uint32[...] (limb axis reduced away), replicated over limb shards.
    """
    assert new_modulus < (1 << 32), "collective switch targets a small modulus"
    int_np, frac_np = _ms_parts(params, new_modulus)
    limb_sh = NamedSharding(mesh, P(limb_axis))
    int_parts = jax.device_put(int_np, limb_sh)
    frac_parts = jax.device_put(frac_np, limb_sh)
    pmod = jnp.uint64(new_modulus)

    ndim_rest = data.ndim - 1
    in_spec = P(limb_axis, *([None] * ndim_rest))
    out_spec = P(*([None] * ndim_rest))

    def local(chunk, ints, fracs):
        r = chunk.astype(jnp.uint64)
        shape = (-1,) + (1,) * ndim_rest
        # exact: r < 2^30 (crt_bits cap), I_t mod P < 2^32 -> term < 2^62
        hi_terms = (r * ints.reshape(shape)) % pmod
        # local sums < L*P < 2^53: exact in float64, psum-able on any backend
        hi_local = jnp.sum(hi_terms, axis=0).astype(jnp.float64)
        fr_local = jnp.sum(r.astype(jnp.float64) * fracs.reshape(shape), axis=0)
        hi = jax.lax.psum(hi_local, limb_axis)
        fr = jax.lax.psum(fr_local, limb_axis)
        hi = jnp.mod(hi, jnp.float64(new_modulus)).astype(jnp.uint64)
        fr_floor = jnp.floor(fr)
        carry = (
            fr_floor.astype(jnp.uint64)
            + jnp.where(fr - fr_floor >= 0.5, 1, 0).astype(jnp.uint64)
        ) % pmod
        return ((hi + carry) % pmod).astype(jnp.uint32)

    fn = shard_map(
        local, mesh=mesh, in_specs=(in_spec, P(limb_axis), P(limb_axis)),
        out_specs=out_spec,
    )
    return jax.jit(fn)(data, int_parts, frac_parts)
