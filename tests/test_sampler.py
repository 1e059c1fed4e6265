"""Sampler tests: determinism, window exactness, distributions, trapdoor."""

import numpy as np
import pytest

import mxx_tpu  # noqa: F401

from mxx_tpu.ring.params import RingParams
from mxx_tpu.matrix import PolyMatrix
from mxx_tpu.sampler import (
    BitDist,
    FinRingDist,
    GaussDist,
    HashSampler,
    TernaryDist,
    Trapdoor,
    TrapdoorSampler,
    UniformSampler,
)

KEY = bytes(range(32))
SIGMA = 4.578


def centered_max(mat: PolyMatrix) -> int:
    """Max |coeff| over all entries, coefficients centered mod q."""
    p = mat.params
    q = p.modulus
    arr = np.asarray(mat.to_coeff().data)
    m = 0
    for i in range(mat.nrow):
        for j in range(mat.ncol):
            for t in range(p.n):
                c = p.reconstruct_coeff(arr[:, i, j, t])
                m = max(m, min(c, q - c))
    return m


def test_hash_sampler_deterministic_and_window_exact():
    params = RingParams.default()
    s = HashSampler()
    a = s.sample_hash(params, KEY, b"tag1", 2, 6, FinRingDist())
    b = s.sample_hash(params, KEY, b"tag1", 2, 6, FinRingDist())
    assert a == b
    c = s.sample_hash(params, KEY, b"tag2", 2, 6, FinRingDist())
    assert not (a == c)
    # column window regenerates the same bits as slicing the full matrix
    win = s.sample_hash_columns(params, KEY, b"tag1", 2, 6, 2, 3, FinRingDist())
    assert win == a.slice_columns(2, 5)


def test_hash_sampler_dists():
    params = RingParams.new(16, 2, 20, 1)
    s = HashSampler()
    q = params.modulus
    bits = s.sample_hash(params, KEY, b"b", 1, 4, BitDist())
    for j in range(4):
        assert set(bits.entry(0, j).coeffs()) <= {0, 1}
    tern = s.sample_hash(params, KEY, b"t", 1, 4, TernaryDist())
    for j in range(4):
        assert set(tern.entry(0, j).coeffs()) <= {0, 1, q - 1}
    g = s.sample_hash(params, KEY, b"g", 1, 8, GaussDist(SIGMA))
    assert centered_max(g) <= int(12 * SIGMA) + 1


def test_uniform_sampler_fresh():
    params = RingParams.default()
    s = UniformSampler(seed=7)
    a = s.sample_uniform(params, 2, 2, FinRingDist())
    b = s.sample_uniform(params, 2, 2, FinRingDist())
    assert not (a == b)
    # reproducible given the seed
    s2 = UniformSampler(seed=7)
    a2 = s2.sample_uniform(params, 2, 2, FinRingDist())
    assert a == a2


def test_gauss_distribution_moments():
    params = RingParams.new(256, 1, 28, 1)
    s = UniformSampler(seed=11)
    g = s.sample_uniform(params, 4, 4, GaussDist(SIGMA))
    q = params.modulus
    arr = np.asarray(g.to_coeff().data)[0].astype(np.int64)
    arr = np.where(arr > q // 2, arr - q, arr)
    vals = arr.ravel().astype(np.float64)
    assert abs(vals.mean()) < 0.5
    assert abs(vals.std() - SIGMA) < 0.5


@pytest.mark.parametrize("n,depth,crt_bits,base_bits,d", [(4, 2, 17, 1, 1), (16, 2, 20, 5, 2)])
def test_trapdoor_preimage_identity(n, depth, crt_bits, base_bits, d):
    params = RingParams.new(n, depth, crt_bits, base_bits)
    ts = TrapdoorSampler(params, SIGMA, seed=3)
    td, a = ts.trapdoor(params, d)
    k = params.modulus_digits
    assert a.shape == (d, d * (k + 2))
    target = UniformSampler(seed=5).sample_uniform(params, d, 3, FinRingDist())
    x = ts.preimage(params, td, a, target)
    assert x.shape == (d * (k + 2), 3)
    assert (a @ x) == target
    # preimage entries are small (perturbation + digits + R/E products)
    s = 1.8 * (params.base + 1) * SIGMA * SIGMA * (
        np.sqrt(d * n * k) + np.sqrt(2 * n) + 4.7
    )
    assert centered_max(x) < 30 * s * np.sqrt(d * k * n)


def test_preimage_extend_identity():
    params = RingParams.default()
    ts = TrapdoorSampler(params, SIGMA, seed=9)
    td, b = ts.trapdoor(params, 1)
    us = UniformSampler(seed=13)
    c = us.sample_uniform(params, 1, 2, FinRingDist())
    u = us.sample_uniform(params, 1, 2, FinRingDist())
    x = ts.preimage_extend(params, td, b, c, u)
    assert (b.concat_columns([c]) @ x) == u


def test_trapdoor_serde():
    params = RingParams.default()
    ts = TrapdoorSampler(params, SIGMA, seed=1)
    td, _ = ts.trapdoor(params, 1)
    back = Trapdoor.from_compact_bytes(params, td.to_compact_bytes())
    assert back.r == td.r and back.e == td.e


def test_preimage_not_plain_gadget_solution():
    """The gadget-block rows must be a randomized Gaussian coset sample, not
    the deterministic digit decomposition (reference
    gpu.rs test_gpu_preimage_generation_square_not_plain_gadget_solution)."""
    params = RingParams.new(16, 2, 20, 5)
    ts = TrapdoorSampler(params, SIGMA, seed=21)
    td, a = ts.trapdoor(params, 1)
    target = UniformSampler(seed=22).sample_uniform(params, 1, 2, FinRingDist())
    x = ts.preimage(params, td, a, target)
    assert (a @ x) == target
    # digits of the bottom block exceed the base (impossible for plain G^-1)
    k = params.modulus_digits
    bot = x.slice_rows(2, 2 + k)
    vals = np.asarray(bot.to_coeff().data[0]).astype(np.int64)
    q0 = params.moduli[0]
    vals = np.where(vals > q0 // 2, vals - q0, vals)
    assert vals.min() < 0, "coset sample must contain negative digits"
    assert np.abs(vals).max() >= params.base, "plain digit decomposition detected"
    # two preimages of the same target differ (randomized sampler)
    x2 = ts.preimage(params, td, a, target)
    assert (a @ x2) == target
    assert x != x2


def test_preimage_perturbation_covariance_tables():
    """LDL tables: leading slot variance equals s^2 - c^2 * a_00 and the
    sampled p1 stays within the s-scale envelope."""
    from mxx_tpu.sampler.trapdoor import (
        _build_p1_cov,
        _centered_lift_f64,
        _p1_ldl_tables,
        preimage_smoothing_parameter,
    )

    params = RingParams.new(16, 2, 20, 5)
    ts = TrapdoorSampler(params, SIGMA, seed=31)
    td, a = ts.trapdoor(params, 1)
    a_c = np.asarray(_centered_lift_f64(td.a_mat()))
    b_c = np.asarray(_centered_lift_f64(td.b_mat()))
    d_c = np.asarray(_centered_lift_f64(td.d_mat()))
    s = preimage_smoothing_parameter(params.base, SIGMA, 1, params.n, params.modulus_digits)
    cov = _build_p1_cov(a_c, b_c, d_c, s, ts.c)
    sqrt_var, upd = _p1_ldl_tables(cov, SIGMA**2)
    # last pivot is untouched by elimination: var = s^2 - c^2 * d_00
    want_last = s * s - ts.c * ts.c * d_c[0, 0]
    assert np.allclose(sqrt_var[:, 1] ** 2, want_last)
    assert np.all(sqrt_var > 0)
    # per-slot Gram coefficients are signed, so pivots wobble around s but
    # stay within the c^2 * |gram| envelope of s^2
    gram_bound = ts.c**2 * max(np.abs(a_c).max(), np.abs(b_c).max(), np.abs(d_c).max())
    assert np.all(np.abs(sqrt_var**2 - s * s) <= 2 * gram_bound + 1e-6)


def test_preimage_batched_sharded_mesh():
    """Batched preimages over the 8-device CPU mesh equal per-request calls
    in relation (A x == U per request)."""
    from mxx_tpu.parallel.mesh import make_mesh

    params = RingParams.new(16, 2, 20, 5)
    ts = TrapdoorSampler(params, SIGMA, seed=51)
    td, a = ts.trapdoor(params, 1)
    us = UniformSampler(seed=52)
    targets = [us.sample_uniform(params, 1, w, FinRingDist()) for w in (3, 5, 4)]
    mesh = make_mesh()
    outs = ts.preimage_batched_sharded(params, td, a, targets, mesh=mesh)
    assert len(outs) == 3
    for t, x in zip(targets, outs):
        assert x.ncol == t.ncol
        assert (a @ x) == t


def test_chacha_rfc8439_block_vector():
    """The device ChaCha20 block function must match RFC 8439 §2.3.2."""
    from mxx_tpu.sampler import chacha

    assert chacha._self_test_vector()


def test_chacha_streams_distinct_and_deterministic():
    from mxx_tpu.sampler import chacha
    import numpy as np

    k1 = chacha.key_from_bytes(bytes(range(32)))
    k2 = chacha.key_from_bytes(bytes(range(1, 33)))
    a = np.asarray(chacha.random_bits(k1, (8,)))
    b = np.asarray(chacha.random_bits(k1, (8,)))
    c = np.asarray(chacha.random_bits(k2, (8,)))
    assert (a == b).all(), "same key must reproduce"
    assert (a != c).any(), "different keys must differ"
    f1 = np.asarray(chacha.fold_in(k1, 7))
    f2 = np.asarray(chacha.fold_in(k1, 8))
    assert (f1 != f2).any()


def test_sample_hash_batch_matches_per_tag():
    """Batched multi-tag hash sampling must be bit-identical to per-tag calls
    (offline K_low derivations batch; online re-derives per tag)."""
    from mxx_tpu.sampler import FinRingDist, HashSampler

    params = RingParams.new(8, 3, 20, 10)
    hs = HashSampler()
    key = bytes(range(32))
    tags = [f"t{i}" for i in range(5)]
    batch = hs.sample_hash_batch(params, key, tags, 2, 6, FinRingDist())
    for tag, got in zip(tags, batch):
        want = hs.sample_hash(params, key, tag, 2, 6, FinRingDist())
        assert got == want, tag


@pytest.mark.parametrize("n_devices", [4, 8])
def test_preimage_batched_sharded_default_mesh_uses_every_device(n_devices):
    """make_mesh's default puts 4 devices on `limb`; the column-sharded
    preimage plane still gives each device its own block of columns."""
    from mxx_tpu.parallel.mesh import make_mesh

    params = RingParams.new(16, 2, 20, 5)
    ts = TrapdoorSampler(params, SIGMA, seed=53)
    td, a = ts.trapdoor(params, 1)
    target = UniformSampler(seed=54).sample_uniform(params, 1, 2 * n_devices, FinRingDist())
    x = ts.preimage_batched_sharded(params, td, a, [target], mesh=make_mesh(n_devices))[0]
    shards = x.data.addressable_shards
    assert len({s.device for s in shards}) == n_devices
    assert {s.data.shape[2] for s in shards} == {2}
    assert (a @ x) == target
