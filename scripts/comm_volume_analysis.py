"""Multi-chip communication-volume analysis (VERDICT r2 weak #5).

One real chip cannot measure scaling efficiency, but the compiled programs
can make the claim inspectable: for each sharded offline plane we compile the
jitted program over an 8-virtual-device (limb x col) mesh, parse the
optimized HLO for collective ops (all-reduce / all-gather / reduce-scatter /
collective-permute / all-to-all), and report

  - collective bytes moved per device per step (the interconnect traffic), vs
  - the FLOP-proportional compute bytes each shard touches (the work), vs
  - the bytes a replicated single-chip program would touch (the baseline).

Scaling efficiency at N devices ~ compute_per_shard / (compute_per_shard +
comm / link_bw * compute_bw). The sharded preimage plane and the limb-sharded
NTT/matmul pipeline are embarrassingly parallel by construction (zero
collectives expected); the CRT-switch collective is the one communicating
step, and its volume is L-fold smaller than the operand it folds.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/comm_volume_analysis.py
"""

import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

import mxx_tpu  # noqa: F401
from mxx_tpu.utils.compile_cache import enable_compile_cache
from mxx_tpu.ring.params import RingParams
from mxx_tpu.matrix import PolyMatrix
from mxx_tpu.sampler import FinRingDist, TrapdoorSampler, UniformSampler
from mxx_tpu.parallel import factor_devices
from mxx_tpu.parallel.mesh import column_mesh
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_DTYPE_BYTES = {
    "u8": 1, "s8": 1, "pred": 1, "u16": 2, "s16": 2, "bf16": 2, "f16": 2,
    "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8, "f64": 8,
}


def collective_bytes(hlo_text: str) -> dict:
    """Sum output bytes of every collective instruction in optimized HLO."""
    out = {}
    for line in hlo_text.splitlines():
        s = line.strip()
        # match instructions like:  %ar = u32[4,2,64] all-reduce(...)
        for kind in COLLECTIVES:
            if f" {kind}(" in s or s.startswith(kind + "("):
                m = _SHAPE_RE.search(s.split("=", 1)[-1])
                if m:
                    dt, dims = m.group(1), m.group(2)
                    nbytes = _DTYPE_BYTES.get(dt, 4)
                    for d in dims.split(","):
                        if d:
                            nbytes *= int(d)
                    out[kind] = out.get(kind, 0) + nbytes
                break
    return out


def analyze(name, jitted, args, shardings=None):
    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    texts = compiled.as_text()
    cb = collective_bytes(texts)
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    total_comm = sum(cb.values())
    flops = cost.get("flops", 0.0) if cost else 0.0
    bytes_acc = cost.get("bytes accessed", 0.0) if cost else 0.0
    print(f"\n== {name}")
    print(f"   collectives: {cb if cb else 'NONE (embarrassingly parallel)'}")
    print(f"   comm bytes/step total: {total_comm:,}")
    print(f"   per-shard flops: {flops:,.0f}  bytes accessed: {bytes_acc:,.0f}")
    if total_comm and bytes_acc:
        print(f"   comm/compute byte ratio: {total_comm / bytes_acc:.4f}")
    return cb, cost


def main():
    enable_compile_cache()
    n_dev = len(jax.devices())
    nl, nc = factor_devices(n_dev)
    mesh = Mesh(np.array(jax.devices()).reshape(nl, nc), ("limb", "col"))
    print(f"devices={n_dev} mesh=({nl} limb x {nc} col)")

    # --- Plane 1: sharded preimage batch (P4) --------------------------------
    # Columns of a batched preimage target are embarrassingly parallel; the
    # fused preimage program sharded over the col axis must compile with ZERO
    # collectives: every shard samples its own p2/p1/G-coset chain. Like
    # preimage_batched_sharded, it lays every device along col.
    pmesh = column_mesh(mesh)
    params = RingParams.new(64, 2, 20, 10)
    ts = TrapdoorSampler(params, 4.578, seed=3)
    td, pub = ts.trapdoor(params, 1)
    us = UniformSampler(seed=4)
    cols = 4 * n_dev
    tgt = us.sample_uniform(params, 1, cols, FinRingDist()).to_eval()

    core = ts._preimage_core(params, td, pub, 1)
    s = __import__("mxx_tpu.sampler.trapdoor", fromlist=["x"]).preimage_smoothing_parameter(
        ts.base, ts.sigma, 1, params.n, params.modulus_digits)
    r_data, e_data, pub_data, sqrt_var, upd = ts._preimage_operands(params, td, pub, s)
    sharded_fn = jax.jit(ts._sharded_preimage_fn(pmesh, core))
    tgt_sh = jax.device_put(tgt.data, NamedSharding(pmesh, P(None, None, "col", None)))
    args = (tgt_sh, r_data, e_data, pub_data, sqrt_var, upd, jnp.uint32(7))
    with pmesh:
        cb, _ = analyze("preimage plane, col-sharded shard_map (P4)", sharded_fn, args)
    assert not cb, f"preimage plane must be collective-free, got {cb}"

    # Replicated baseline: same program, no sharding -> every chip touches the
    # full plane. Per-device bytes under col-sharding = full/n_dev.
    full_bytes = int(np.prod(tgt.data.shape)) * 4
    out_rows = 2 * 1 + 1 * params.modulus_digits
    out_bytes = params.crt_depth * out_rows * cols * params.n * 4
    print(f"   operand bytes {full_bytes:,}; output bytes {out_bytes:,}; "
          f"per-device share 1/{n_dev} of compute, 0 collective bytes")
    print(f"   -> scaling efficiency model: eff(N_col) = 1.0 (no comm term); "
          f"wall limited only by per-shard compute")

    # --- Plane 2: limb-sharded NTT->matmul->iNTT pipeline (P2+P3) ------------
    from mxx_tpu.ring.ntt import ntt_fwd, ntt_inv
    from mxx_tpu.ops.zq_matmul import zq_matmul

    depth = max(2, nl)
    p2 = RingParams.new(64, depth, 20, 5)
    jt = p2.jt
    rng = np.random.default_rng(0)

    def rand(shape):
        out = np.empty((depth,) + shape, dtype=np.uint32)
        for t, q in enumerate(p2.moduli):
            out[t] = rng.integers(0, q, size=shape, dtype=np.uint64).astype(np.uint32)
        return jnp.asarray(out)

    a = jax.device_put(rand((2, 4, 64)), NamedSharding(mesh, P("limb", None, None, None)))
    b = jax.device_put(rand((4, 2 * nc, 64)), NamedSharding(mesh, P("limb", None, "col", None)))
    tab = lambda x, spec: jax.device_put(np.asarray(x), NamedSharding(mesh, spec))
    psi = tab(p2.np_psi_rev_mont, P("limb"))
    psi_i = tab(p2.np_psi_inv_rev_mont, P("limb"))
    n_inv = tab(p2.np_n_inv_mont, P("limb"))
    q = tab(p2.np_moduli, P("limb"))
    qinv = tab(p2.np_qinv_neg, P("limb"))
    cp = tab(p2.np_combine_pows_mont, P(None, "limb"))
    sc = tab(p2.np_sign_corr_pows, P(None, "limb"))

    # Col sharding is applied plane-level via shard_map (automatic GSPMD
    # propagates the LIMB axis through every op collective-free, but loses a
    # minor-axis col sharding at the NTT's batch-dim flatten and re-gathers;
    # the production sharded planes — preimage, LWE offline, injector — all
    # ride shard_map for exactly this reason, trapdoor._sharded_preimage_fn).
    from jax import shard_map

    def step_local(a, b, psi, psi_i, n_inv, q, qinv, cp, sc):
        from mxx_tpu.parallel.mesh import pcast_varying
        vary = lambda x: pcast_varying(
            x, tuple({"limb", "col"} - set(getattr(jax.typeof(x), "vma", ()))))
        a, b, psi, psi_i, n_inv, q, qinv, cp, sc = map(
            vary, (a, b, psi, psi_i, n_inv, q, qinv, cp, sc))
        fa = ntt_fwd(a, psi, q, qinv)
        fb = ntt_fwd(b, psi, q, qinv)
        fc = zq_matmul(fa, fb, q, qinv, cp, sc)
        return ntt_inv(fc, psi_i, n_inv, q, qinv)

    step = jax.jit(shard_map(
        step_local, mesh=mesh,
        in_specs=(P("limb", None, None, None), P("limb", None, "col", None),
                  P("limb"), P("limb"), P("limb"), P("limb"), P("limb"),
                  P(None, "limb"), P(None, "limb")),
        out_specs=P("limb", None, "col", None),
    ))

    with mesh:
        cb2, _ = analyze("NTT->matmul->iNTT, limb x col shard_map (P2+P3)",
                         step, (a, b, psi, psi_i, n_inv, q, qinv, cp, sc))
    assert not cb2, f"limb/col pipeline must be collective-free, got {cb2}"

    # --- Plane 3: CRT-switch collective (P9) ---------------------------------
    # The ONE communicating step: folding the sharded limb axis into a new
    # modulus needs a psum over limb shards. Communication = output plane
    # (1/L of the operand) x log-tree factors — bytes reported from HLO.
    from mxx_tpu.parallel.crt_collective import crt_switch_sharded

    operand = jax.device_put(rand((2, 4, 64)), NamedSharding(mesh, P("limb", None, None, None)))
    fold = jax.jit(lambda x: crt_switch_sharded(p2, x, 1 << 16, mesh))
    with mesh:
        cb3, cost3 = analyze("CRT-switch collective (P9)", fold, (operand,))
    op_bytes = int(np.prod(operand.shape)) * 4
    comm = sum(cb3.values())
    print(f"   operand bytes {op_bytes:,} -> collective bytes {comm:,} "
          f"({comm / op_bytes:.2f}x operand; the folded plane is 1/L of it)")
    print("\nSummary: offline planes (preimage, NTT/matmul) shard with zero "
          "collective traffic; the CRT switch is the only collective and moves ~1/L "
          "of its operand. Scaling loss comes only from per-shard load "
          "imbalance.")


if __name__ == "__main__":
    main()
