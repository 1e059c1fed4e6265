"""Device-mesh helpers: limb/column sharding for DCRT polynomial matrices.

The parallelism design (SURVEY.md §2.7): CRT limbs are independent
moduli, so the limb axis shards with ZERO communication (the analog of the
reference's per-limb CUDA grid axis, MatrixNTT.cu:39); matrix column blocks
shard like tensor parallelism (the analog of column-chunk pipelines, P5);
batches of preimage/gate tasks shard data-parallel (P4, multi-GPU round
robin). CRT reconstruction and row-block reductions use psum (P9).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LIMB_AXIS = "limb"
COL_AXIS = "col"


def factor_devices(n_devices: int) -> tuple[int, int]:
    """Split n_devices into (limb_shards, col_shards), preferring 2D."""
    nl = 1
    m = n_devices
    while m % 2 == 0 and nl < 4:
        nl *= 2
        m //= 2
    return nl, n_devices // nl


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    nl, nc = factor_devices(len(devs))
    return Mesh(np.array(devs).reshape(nl, nc), (LIMB_AXIS, COL_AXIS))


def column_mesh(mesh: Mesh) -> Mesh:
    """`mesh`'s devices laid out along `col` alone, for a path that shards
    only columns: on a limb axis of size > 1 it would run redundant copies."""
    if mesh.shape[LIMB_AXIS] == 1:
        return mesh
    return Mesh(mesh.devices.reshape(1, -1), (LIMB_AXIS, COL_AXIS))


def matrix_sharding(mesh: Mesh, shard_cols: bool = False) -> NamedSharding:
    """Sharding for uint32[L, r, c, n]: limbs always sharded; columns optional."""
    return NamedSharding(mesh, P(LIMB_AXIS, None, COL_AXIS if shard_cols else None, None))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-limb tables uint32[L, ...]."""
    return NamedSharding(mesh, P(LIMB_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pcast_varying(x, axes):
    """Mark `x` as varying over the manual mesh `axes` (no-op for none)."""
    axes = tuple(axes)
    if not axes:
        return x
    return jax.lax.pcast(x, axes, to="varying")
