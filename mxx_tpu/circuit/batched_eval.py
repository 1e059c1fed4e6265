"""Level-batched circuit evaluation over BGG wires.

Build of the reference's level-parallel evaluator
(/root/reference/src/circuit/poly_circuit/eval.rs:210-921 with
MXX_CIRCUIT_PARALLEL_GATES, analysis.rs GroupedExecutionPlan): gates are
walked level by level; same-kind same-shape gates within a level collapse
into ONE device program over a row-stacked operand tensor. Where the
reference fans gates across rayon threads / GPU streams, the array-first
answer is a bigger array: stacking B one-row wires gives [L, B, m, n]
operands that the existing exact kernels (ew_*, zq_matmul, digit_decompose)
consume unchanged, so batched results are bit-identical to sequential ones.

Batched kinds: Add/Sub/Mul/SmallScalarMul/LargeScalarMul over
BggEncoding/BggPublicKey wires (the gate soup of nested-RNS circuits).
Everything else (PubLut, slot gates, sub-circuit calls, foreign wire types)
falls back to the sequential per-gate path inside the same level walk, so
`eval_batched` accepts any circuit `eval` accepts.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_add, ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from .gate import (
    ADD,
    INPUT,
    LARGE_SCALAR_MUL,
    MUL,
    PUB_LUT,
    SMALL_SCALAR_MUL,
    SUB,
)

MIN_BATCH = 3
# Batch widths above this pad to the next power of two: protocol circuits
# produce a fresh width per level, and every fresh width is a fresh XLA
# compile of each batch kernel (compiles dominated the round-4 real-mode
# profile). Below the threshold the duplicated tail's real compute loses
# more than the compile cache saves.
PAD_POW2_MIN = 16

_BATCHABLE = {ADD, SUB, MUL, SMALL_SCALAR_MUL, LARGE_SCALAR_MUL}


class WireStore:
    """Wire map with a device-resident byte budget (reference eval.rs
    compact-form wire caching, :24-27 and :210-921): when live wires exceed
    `budget_bytes`, the least-recently-touched BGG wires spill to host compact
    bytes and rehydrate transparently on next access. `peak_live_bytes`
    records the high-water mark for tests/benches."""

    def __init__(self, params, budget_bytes: int = 0):
        self.params = params
        self.budget = budget_bytes
        self.live: dict = {}
        self.spilled: dict = {}
        self.clock = 0
        self.last_touch: dict = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.spill_count = 0

    # -- byte accounting (uint32 limb planes)

    @staticmethod
    def _wire_bytes(w) -> int:
        from ..bgg import BggEncoding, BggPublicKey

        if isinstance(w, BggEncoding):
            total = int(w.vector.data.nbytes) + int(w.pubkey.matrix.data.nbytes)
            return total
        if isinstance(w, BggPublicKey):
            return int(w.matrix.data.nbytes)
        return 0  # foreign wire types are not tracked or spilled

    # -- compact-form spill/rehydrate

    def _to_compact(self, w):
        from ..bgg import BggEncoding, BggPublicKey

        if isinstance(w, BggEncoding):
            pt = w.plaintext.to_compact_bytes() if w.plaintext is not None else None
            return (
                "enc",
                w.vector.to_compact_bytes(),
                w.pubkey.matrix.to_compact_bytes(),
                w.pubkey.reveal_plaintext,
                pt,
            )
        assert isinstance(w, BggPublicKey)
        return ("pk", w.matrix.to_compact_bytes(), w.reveal_plaintext)

    def _from_compact(self, rec):
        from ..bgg import BggEncoding, BggPublicKey
        from ..matrix import PolyMatrix
        from ..ring.poly import Poly

        if rec[0] == "enc":
            _, vec_b, pk_b, reveal, pt_b = rec
            pt = Poly.from_compact_bytes(self.params, pt_b) if pt_b is not None else None
            return BggEncoding(
                PolyMatrix.from_compact_bytes(self.params, vec_b),
                BggPublicKey(PolyMatrix.from_compact_bytes(self.params, pk_b), reveal),
                pt,
            )
        _, m_b, reveal = rec
        return BggPublicKey(PolyMatrix.from_compact_bytes(self.params, m_b), reveal)

    def _enforce(self):
        if not self.budget or self.live_bytes <= self.budget:
            return
        # spill least-recently-touched spillable wires until under budget
        order = sorted(
            (gid for gid in self.live if _is_bgg(self.live[gid])),
            key=lambda gid: self.last_touch.get(gid, 0),
        )
        for gid in order:
            if self.live_bytes <= self.budget:
                break
            w = self.live.pop(gid)
            self.live_bytes -= self._wire_bytes(w)
            self.spilled[gid] = self._to_compact(w)
            self.spill_count += 1

    # -- mapping surface used by the evaluator

    def __setitem__(self, gid, w):
        self.pop(gid, None)
        self.live[gid] = w
        self.clock += 1
        self.last_touch[gid] = self.clock
        self.live_bytes += self._wire_bytes(w)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        self._enforce()

    def __getitem__(self, gid):
        if gid in self.live:
            self.clock += 1
            self.last_touch[gid] = self.clock
            return self.live[gid]
        w = self._from_compact(self.spilled.pop(gid))
        self[gid] = w
        return w

    def __contains__(self, gid):
        return gid in self.live or gid in self.spilled

    def pop(self, gid, default=None):
        if gid in self.live:
            w = self.live.pop(gid)
            self.live_bytes -= self._wire_bytes(w)
            self.last_touch.pop(gid, None)
            return w
        return self.spilled.pop(gid, default)


def _pad_pow2(items: list) -> list:
    """Pad wide batches to the next power of two (repeat the last gate) so
    kernel shapes hit the XLA compile cache; executors slice back to the real
    count. Small batches stay exact (the repeated tail is real compute)."""
    n = len(items)
    if n <= PAD_POW2_MIN:
        return items
    target = 1
    while target < n:
        target *= 2
    return items + [items[-1]] * (target - n)


def _is_bgg(w) -> bool:
    from ..bgg import BggEncoding, BggPublicKey

    return isinstance(w, (BggEncoding, BggPublicKey))


def _wire_sig(circuit, wires, g):
    """Group signature: gates with equal signatures batch together."""
    from ..bgg import BggEncoding, BggPublicKey

    ins = [wires[i] for i in g.inputs]
    if not all(_is_bgg(w) for w in ins):
        return None
    kinds = tuple(type(w).__name__ for w in ins)
    shapes = []
    for w in ins:
        m = w.vector if isinstance(w, BggEncoding) else w.matrix
        shapes.append(m.shape)
        if isinstance(w, BggEncoding):
            shapes.append(w.pubkey.matrix.shape)
    if g.kind == MUL:
        left, right = ins[0], ins[1]
        if type(left) is not type(right):
            return None
        if isinstance(left, BggEncoding):
            if left.plaintext is None:
                return None
        elif not isinstance(left, BggPublicKey):
            return None  # pk x pk batches via the same A1 @ G^{-1}(A2) kernel
    return (g.kind, kinds, tuple(shapes))


def _stack(mats, params):
    """Row-concatenate one-row (or equal-shape) PolyMatrix EVAL datas along a
    fresh batch axis folded into rows: [L, B*r, c, n]. Host numpy concatenate
    when every operand is host-resident (numpy views from a previous unstack)
    — avoids one eager device op per operand."""
    import numpy as np

    datas = [m.to_eval().data for m in mats]
    if all(isinstance(d, np.ndarray) for d in datas):
        return np.concatenate(datas, axis=1)
    return jnp.concatenate(datas, axis=1)


def _unstack(params, data, count, rows):
    """Split a batched result into per-gate matrices: ONE host fetch, then
    zero-copy numpy views (previously an eager device slice per gate — the
    dominant steady-state cost in LUT-heavy circuits, round-3 profile).
    Downstream jitted ops accept numpy operands and re-upload on use."""
    import numpy as np

    from ..matrix import PolyMatrix
    from ..ring.poly import EVAL

    host = np.asarray(data)
    return [
        PolyMatrix(host[:, i * rows : (i + 1) * rows], EVAL, params)
        for i in range(count)
    ]


def _stack_polys(polys, params):
    import numpy as np

    datas = [p.to_eval().data for p in polys]  # each [L, n]
    if all(isinstance(d, np.ndarray) for d in datas):
        # host stack: jnp.stack traces a convert per operand — thousands of
        # small host arrays per level made the stack itself the bottleneck
        return np.stack(datas, axis=1)
    return jnp.stack(datas, axis=1)  # [L, B, n]


def _batched_ew(kind, params, a_data, b_data):
    jt = params.jt
    if kind == ADD:
        return ew_add(a_data, b_data, jt.moduli)
    return ew_sub(a_data, b_data, jt.moduli)


def _batched_plaintexts(kind, params, pas, pbs):
    """Batched plaintext +/-/* for B gates: ONE device program + ONE host
    fetch, numpy-view Poly results (per-gate Poly ops were a device dispatch
    per gate — with thousands of gates per level the dispatches dominated).
    Gates with a missing operand plaintext get None, as in the per-gate
    path."""
    import numpy as np

    from ..ring.poly import EVAL, Poly

    present = [
        i for i in range(len(pas)) if pas[i] is not None and pbs[i] is not None
    ]
    out_list = [None] * len(pas)
    if not present:
        return out_list
    jt = params.jt
    a = _stack_polys([pas[i] for i in present], params)  # [L, P, n]
    b = _stack_polys([pbs[i] for i in present], params)
    if kind == ADD:
        out = ew_add(a, b, jt.moduli)
    elif kind == SUB:
        out = ew_sub(a, b, jt.moduli)
    else:
        out = ew_mul(a, b, jt.moduli, jt.qinv_neg, jt.r2)
    host = np.asarray(out)
    for j, i in enumerate(present):
        out_list[i] = Poly(host[:, j], EVAL, params)
    return out_list


def _exec_add_sub(circuit, params, gates, wires):
    from ..bgg import BggEncoding, BggPublicKey

    n_real = len(gates)
    gates = _pad_pow2(list(gates))
    ins_a = [wires[g.inputs[0]] for g in gates]
    ins_b = [wires[g.inputs[1]] for g in gates]
    kind = gates[0].kind
    enc = isinstance(ins_a[0], BggEncoding)
    if enc:
        rows = ins_a[0].vector.nrow
        vec = _batched_ew(
            kind, params,
            _stack([w.vector for w in ins_a], params),
            _stack([w.vector for w in ins_b], params),
        )
        vecs = _unstack(params, vec, len(gates), rows)
    prow = (ins_a[0].pubkey.matrix if enc else ins_a[0].matrix).nrow
    pk = _batched_ew(
        kind, params,
        _stack([(w.pubkey.matrix if enc else w.matrix) for w in ins_a], params),
        _stack([(w.pubkey.matrix if enc else w.matrix) for w in ins_b], params),
    )
    pks = _unstack(params, pk, len(gates), prow)
    if enc:
        pts = _batched_plaintexts(
            kind, params,
            [w.plaintext for w in ins_a], [w.plaintext for w in ins_b],
        )
    outs = []
    for i in range(n_real):
        a, b = ins_a[i], ins_b[i]
        if enc:
            reveal = a.pubkey.reveal_plaintext and b.pubkey.reveal_plaintext
            outs.append(BggEncoding(vecs[i], BggPublicKey(pks[i], reveal), pts[i]))
        else:
            outs.append(BggPublicKey(pks[i], a.reveal_plaintext and b.reveal_plaintext))
    return outs


def _scalar_polys(params, gates, resolve):
    from ..ring.poly import Poly

    out = []
    for g in gates:
        coeffs = list(resolve(g))
        coeffs = coeffs + [0] * (params.n - len(coeffs))
        out.append(Poly.from_int_coeffs(params, coeffs))
    return out


def _exec_scalar_mul(circuit, params, gates, wires, resolve):
    """SmallScalarMul batched: elementwise multiply by per-gate scalar polys."""
    from ..bgg import BggEncoding, BggPublicKey

    n_real = len(gates)
    gates = _pad_pow2(list(gates))
    ins = [wires[g.inputs[0]] for g in gates]
    scalars = _scalar_polys(params, gates, resolve)
    s_data = _stack_polys(scalars, params)  # [L, B, n]
    jt = params.jt
    enc = isinstance(ins[0], BggEncoding)
    B = len(gates)

    def mul_stacked(mats):
        rows = mats[0].nrow
        data = _stack(mats, params)  # [L, B*rows, c, n]
        s = jnp.repeat(s_data, rows, axis=1)[:, :, None, :]  # [L, B*rows, 1, n]
        return _unstack(params, ew_mul(data, s, jt.moduli, jt.qinv_neg, jt.r2), B, rows)

    pks = mul_stacked([(w.pubkey.matrix if enc else w.matrix) for w in ins])
    if enc:
        vecs = mul_stacked([w.vector for w in ins])
        pts = _batched_plaintexts(
            MUL, params, [w.plaintext for w in ins], scalars
        )
    outs = []
    for i in range(n_real):
        w = ins[i]
        if enc:
            outs.append(
                BggEncoding(
                    vecs[i], BggPublicKey(pks[i], w.pubkey.reveal_plaintext), pts[i]
                )
            )
        else:
            outs.append(BggPublicKey(pks[i], w.reveal_plaintext))
    return outs


def _vmapped_matmul(params, a_data, b_data):
    """[B, L, r, k, n] @ [B, L, k, c, n] via one vmapped exact matmul."""
    import jax

    jt = params.jt
    fn = jax.vmap(zq_matmul, in_axes=(0, 0, None, None, None, None))
    return fn(a_data, b_data, jt.moduli, jt.qinv_neg, jt.combine_pows_mont, jt.sign_corr_pows)


def _np_views_b(data):
    """One host fetch of a [B, ...] batched result; per-gate numpy views."""
    import numpy as np

    return np.asarray(data)


def _batched_decompose(params, mats):
    """Decompose B equal-shape matrices in one program and NTT to EVAL form:
    returns [B, L, r*k, c, n] ready for the exact matmul."""
    from ..ring.ntt import ntt_fwd, ntt_inv
    from ..ring.poly import EVAL

    if all(m.fmt == EVAL for m in mats):
        # ONE batched iNTT for the whole group (a per-matrix to_coeff was an
        # eager device NTT per gate — 20k dispatches in the round-5 real-mode
        # profile)
        stacked = _stack(mats, params)  # [L, B*r, c, n] EVAL
        data = ntt_inv(
            jnp.asarray(stacked), params.jt.psi_inv_rev_mont,
            params.jt.n_inv_mont, params.jt.moduli, params.jt.qinv_neg,
        )
    else:
        data = jnp.concatenate([m.to_coeff().data for m in mats], axis=1)  # [L, B*r, c, n]
    p = params
    dec = digit_decompose(
        data, p.jt.moduli, p.jt.digit_masks,
        base_bits=p.base_bits, dpt=p.digits_per_tower, towers=p.crt_depth,
    )  # [L, B*r*k, c, n] COEFF
    dec = ntt_fwd(dec, p.jt.psi_rev_mont, p.jt.moduli, p.jt.qinv_neg)
    B = len(mats)
    r = mats[0].nrow
    k = p.modulus_digits
    L, _, c, n = dec.shape
    return jnp.transpose(dec.reshape(L, B, r * k, c, n), (1, 0, 2, 3, 4))


def _to_eval_stackb(params, mats):
    """[B, L, r, c, n] from equal-shape matrices."""
    data = jnp.concatenate([m.to_eval().data for m in mats], axis=1)
    B = len(mats)
    r = mats[0].nrow
    L, _, c, n = data.shape
    return jnp.transpose(data.reshape(L, B, r, c, n), (1, 0, 2, 3, 4))


def _exec_mul(circuit, params, gates, wires):
    """BGG mul batched: out = a.vector @ G^{-1}(A_b) + x_a * b.vector."""
    from ..bgg import BggEncoding, BggPublicKey
    from ..matrix import PolyMatrix
    from ..ring.poly import EVAL

    n_real = len(gates)
    gates = _pad_pow2(list(gates))
    ins_a = [wires[g.inputs[0]] for g in gates]
    ins_b = [wires[g.inputs[1]] for g in gates]
    enc_b = isinstance(ins_b[0], BggEncoding)
    enc_a = isinstance(ins_a[0], BggEncoding)
    B = len(gates)
    pk_b = [(w.pubkey.matrix if enc_b else w.matrix) for w in ins_b]
    dec = _batched_decompose(params, pk_b)  # [B, L, m, c, n]
    pk_a = [(w.pubkey.matrix if enc_a else w.matrix) for w in ins_a]
    a_pk = _to_eval_stackb(params, pk_a)
    out_pk = _np_views_b(_vmapped_matmul(params, a_pk, dec))
    jt = params.jt
    outs_pk = [
        PolyMatrix(out_pk[i], EVAL, params) for i in range(B)
    ]
    if enc_a and enc_b:
        a_vec = _to_eval_stackb(params, [w.vector for w in ins_a])
        first = _vmapped_matmul(params, a_vec, dec)
        x_a = _stack_polys([w.plaintext for w in ins_a], params)  # [L, B, n]
        b_vec = _stack([w.vector for w in ins_b], params)  # [L, B*r, c, n]
        rows = ins_b[0].vector.nrow
        x_rep = jnp.repeat(x_a, rows, axis=1)[:, :, None, :]
        second = ew_mul(b_vec, x_rep, jt.moduli, jt.qinv_neg, jt.r2)
        # [B, L, r, c, n] -> [L, B*r, c, n] in one transpose+reshape
        fB, fL, fr, fc, fn = first.shape
        first_flat = jnp.transpose(first, (1, 0, 2, 3, 4)).reshape(fL, fB * fr, fc, fn)
        vec = ew_add(first_flat, second, jt.moduli)
        vecs = _unstack(params, vec, B, rows)
        pts = _batched_plaintexts(
            MUL, params,
            [w.plaintext for w in ins_a], [w.plaintext for w in ins_b],
        )
        outs = []
        for i in range(n_real):
            a, b = ins_a[i], ins_b[i]
            reveal = a.pubkey.reveal_plaintext and b.pubkey.reveal_plaintext
            outs.append(
                BggEncoding(vecs[i], BggPublicKey(outs_pk[i], reveal), pts[i])
            )
        return outs
    return [
        BggPublicKey(outs_pk[i], ins_a[i].reveal_plaintext and ins_b[i].reveal_plaintext)
        for i in range(n_real)
    ]


def _exec_large_scalar_mul(circuit, params, gates, wires, resolve):
    """LSM batched: out = w @ G^{-1}(c * G) per gate scalar c."""
    from ..bgg import BggEncoding, BggPublicKey
    from ..matrix import PolyMatrix
    from ..ring.poly import EVAL

    n_real = len(gates)
    gates = _pad_pow2(list(gates))
    ins = [wires[g.inputs[0]] for g in gates]
    enc = isinstance(ins[0], BggEncoding)
    B = len(gates)
    scalars = _scalar_polys(params, gates, resolve)
    d = (ins[0].pubkey.matrix if enc else ins[0].matrix).nrow
    gadget = PolyMatrix.gadget_matrix(params, d)
    jt = params.jt
    s_data = _stack_polys(scalars, params)  # [L, B, n]
    g_data = gadget.to_eval().data  # [L, d, m, n]
    sg = ew_mul(
        jnp.tile(g_data, (1, B, 1, 1)),
        jnp.repeat(s_data, d, axis=1)[:, :, None, :],
        jt.moduli, jt.qinv_neg, jt.r2,
    )  # [L, B*d, m, n]
    sg_mats = _unstack(params, sg, B, d)
    dec = _batched_decompose(params, sg_mats)  # [B, L, d*k, m, n]
    pk_in = _to_eval_stackb(params, [(w.pubkey.matrix if enc else w.matrix) for w in ins])
    out_pk = _np_views_b(_vmapped_matmul(params, pk_in, dec))
    pks = [PolyMatrix(out_pk[i], EVAL, params) for i in range(B)]
    if enc:
        vec_in = _to_eval_stackb(params, [w.vector for w in ins])
        out_vec = _np_views_b(_vmapped_matmul(params, vec_in, dec))
        pts = _batched_plaintexts(
            MUL, params, [w.plaintext for w in ins], scalars
        )
        outs = []
        for i in range(n_real):
            w = ins[i]
            outs.append(
                BggEncoding(
                    PolyMatrix(out_vec[i], EVAL, params),
                    BggPublicKey(pks[i], w.pubkey.reveal_plaintext),
                    pts[i],
                )
            )
        return outs
    return [BggPublicKey(pks[i], ins[i].reveal_plaintext) for i in range(n_real)]


def eval_batched(circuit, params, one, inputs, plt_evaluator=None,
                 slot_transfer_evaluator=None, param_bindings: tuple = (),
                 live_bytes_budget: int | None = None, wire_store_out: list | None = None):
    """Drop-in for PolyCircuit.eval with level-grouped batched device ops.
    Results are bit-identical to the sequential evaluator. With a
    `live_bytes_budget` (or MXX_CIRCUIT_LIVE_BYTES_BUDGET), idle wires beyond
    the budget spill to host compact bytes (pass `wire_store_out=[]` to
    receive the WireStore for peak/spill introspection)."""
    from .. import config

    assert len(inputs) == circuit.num_input
    uses = circuit.use_counts()
    budget = (
        live_bytes_budget
        if live_bytes_budget is not None
        else config.circuit_live_bytes_budget()
    )
    wires = WireStore(params, budget)
    if wire_store_out is not None:
        wire_store_out.append(wires)
    wires[0] = one
    for i, v in enumerate(inputs):
        wires[i + 1] = v
    remaining = list(uses)
    out_set = set(circuit.output_ids)
    call_cache: dict = {}
    summed_cache: dict = {}

    def consume(gate):
        for i in gate.inputs:
            remaining[i] -= 1
            if remaining[i] == 0 and i not in out_set:
                wires.pop(i, None)

    def eval_sub(circuit_id, sub_inputs, bindings):
        sub = circuit.sub_circuits[circuit_id]
        return eval_batched(
            sub, params, one, sub_inputs, plt_evaluator,
            slot_transfer_evaluator, param_bindings=bindings,
            live_bytes_budget=budget,
        )

    def eval_one(g):
        """Sequential fallback, mirroring PolyCircuit.eval's dispatch."""
        wires[g.gate_id] = circuit._gate_dispatch(
            g, wires, params, one, plt_evaluator, slot_transfer_evaluator,
            param_bindings, call_cache, summed_cache, eval_sub,
        )

    plt_batch = getattr(plt_evaluator, "public_lookup_batch", None)

    for level in circuit.compute_levels():
        # group batchable gates by signature
        groups: dict = {}
        lut_gates = []
        singles = []
        for gid in level:
            g = circuit.gates[gid]
            if g.kind in _BATCHABLE:
                sig = _wire_sig(circuit, wires, g)
                if sig is not None:
                    groups.setdefault(sig, []).append(g)
                    continue
            elif g.kind == PUB_LUT and plt_batch is not None and _is_bgg(wires[g.inputs[0]]):
                lut_gates.append(g)
                continue
            singles.append(g)
        if len(lut_gates) >= 2:
            # group by input wire type/shape: the batch kernels stack operands
            lut_groups: dict = {}
            for g in lut_gates:
                w = wires[g.inputs[0]]
                m = w.vector if hasattr(w, "vector") else w.matrix
                lut_groups.setdefault((type(w).__name__, m.shape), []).append(g)
            for group in lut_groups.values():
                if len(group) < 2:
                    singles.extend(group)
                    continue
                items = [
                    (circuit.luts[g.payload], wires[g.inputs[0]], g.gate_id, g.payload)
                    for g in group
                ]
                for g, out in zip(group, plt_batch(params, items)):
                    wires[g.gate_id] = out
                    consume(g)
        else:
            singles.extend(lut_gates)
        for sig, gates in groups.items():
            if len(gates) < MIN_BATCH:
                singles.extend(gates)
                continue
            kind = sig[0]
            if kind in (ADD, SUB):
                outs = _exec_add_sub(circuit, params, gates, wires)
            elif kind == SMALL_SCALAR_MUL:
                outs = _exec_scalar_mul(
                    circuit, params, gates, wires,
                    lambda g: circuit._resolve_payload(g.payload, param_bindings),
                )
            elif kind == LARGE_SCALAR_MUL:
                outs = _exec_large_scalar_mul(
                    circuit, params, gates, wires,
                    lambda g: circuit._resolve_payload(g.payload, param_bindings),
                )
            elif kind == MUL:
                outs = _exec_mul(circuit, params, gates, wires)
            else:  # pragma: no cover
                singles.extend(gates)
                continue
            for g, out in zip(gates, outs):
                wires[g.gate_id] = out
                consume(g)
        # deterministic order for the sequential remainder
        for g in sorted(singles, key=lambda g: g.gate_id):
            if g.kind == INPUT:
                continue
            eval_one(g)
            consume(g)
        singles.clear()

    return [wires[o] for o in circuit.output_ids]
