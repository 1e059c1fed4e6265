"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Mirrors the reference's multi-GPU logic-level tests (SURVEY.md §4): limb-axis
sharding is zero-communication; column blocks shard like tensor parallelism;
CRT-style reductions psum over the mesh.
"""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mxx_tpu.ring.params import RingParams
from mxx_tpu.ring.ntt import ntt_fwd
from mxx_tpu.ops.zq_matmul import zq_matmul
from mxx_tpu.parallel import factor_devices, make_mesh


def _rand(params, shape, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack(
            [rng.integers(0, q, shape, dtype=np.uint64).astype(np.uint32) for q in params.moduli]
        )
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_limb_and_column_sharded_matmul_matches_single_device():
    mesh = make_mesh(8)
    nl, nc = factor_devices(8)
    params = RingParams.new(32, max(2, nl), 20, 5)
    jt = params.jt
    a = _rand(params, (2, 4, params.n), 20)
    b = _rand(params, (4, 2 * nc, params.n), 21)
    want = zq_matmul(a, b, jt.moduli, jt.qinv_neg, jt.combine_pows_mont, jt.sign_corr_pows)

    sh_a = NamedSharding(mesh, P("limb", None, None, None))
    sh_b = NamedSharding(mesh, P("limb", None, "col", None))
    out = zq_matmul(
        jax.device_put(a, sh_a),
        jax.device_put(b, sh_b),
        jax.device_put(jt.moduli, NamedSharding(mesh, P("limb"))),
        jax.device_put(jt.qinv_neg, NamedSharding(mesh, P("limb"))),
        jax.device_put(jt.combine_pows_mont, NamedSharding(mesh, P(None, "limb"))),
        jax.device_put(jt.sign_corr_pows, NamedSharding(mesh, P(None, "limb"))),
    )
    assert jnp.array_equal(out, want)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_ntt_and_psum_crt_fold():
    mesh = make_mesh(8)
    nl, _ = factor_devices(8)
    params = RingParams.new(64, max(2, nl), 20, 5)
    jt = params.jt
    x = _rand(params, (3, params.n), 22)
    want = ntt_fwd(x, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)

    sh = NamedSharding(mesh, P("limb", None, None))
    got = ntt_fwd(
        jax.device_put(x, sh),
        jax.device_put(jt.psi_rev_mont, NamedSharding(mesh, P("limb", None))),
        jax.device_put(jt.moduli, NamedSharding(mesh, P("limb"))),
        jax.device_put(jt.qinv_neg, NamedSharding(mesh, P("limb"))),
    )
    assert jnp.array_equal(got, want)

    # CRT-style psum reduction over the limb axis
    def fold(v):
        return jax.lax.psum(jnp.sum(v.astype(jnp.float64)), "limb")[None]

    folded = jax.jit(
        shard_map(fold, mesh=mesh, in_specs=P("limb", None, None), out_specs=P("limb"))
    )(jax.device_put(got, sh))
    assert np.isclose(float(np.asarray(folded)[0]), float(np.asarray(got).astype(np.float64).sum()))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("new_mod", [2, 251, 1 << 16])
def test_crt_switch_sharded_exact(new_mod):
    """The P9 CRT-reconstruction collective must match the exact BigInt
    scale-and-round rule per coefficient."""
    from mxx_tpu.parallel.crt_collective import crt_switch_sharded

    mesh = make_mesh(8)
    nl, _ = factor_devices(8)
    depth = 2 * max(2, nl)  # limbs divisible by limb shards
    params = RingParams.new(16, depth, 20, 5)
    q = params.modulus
    x = _rand(params, (3, params.n), 33)
    sh = NamedSharding(mesh, P("limb", None, None))
    got = np.asarray(crt_switch_sharded(params, jax.device_put(x, sh), new_mod, mesh))
    arr = np.asarray(x)
    for j in range(3):
        for t in range(params.n):
            val = params.reconstruct_coeff(arr[:, j, t])
            want = (val * new_mod + q // 2) // q % new_mod
            assert got[j, t] == want, (j, t, got[j, t], want)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_column_mesh_lays_every_device_on_col(n_devices):
    from mxx_tpu.parallel.mesh import COL_AXIS, LIMB_AXIS, column_mesh

    mesh = make_mesh(n_devices)
    cm = column_mesh(mesh)
    assert (cm.shape[LIMB_AXIS], cm.shape[COL_AXIS]) == (1, n_devices)
    assert list(cm.devices.ravel()) == list(mesh.devices.ravel())
    assert column_mesh(cm) is cm
