"""WEE25-commitment-backed LUT evaluation (offline commit / online open).

Build of the reference's src/lookup/commit_eval.rs. Instead of storing a
per-row key matrix for every LUT entry (the LWE/GGH15 evaluators), the whole
table is folded into ONE short WEE25 commitment:

- For gate g (input pubkey A_in, one pubkey A_one) and LUT row j with entry
  (idx_j, y_j), the committed message block at global position start_g + j is
      M = pad(A_out_g - G y_j) + R_{g,idx_j} - (A_in + A_one) G^{-1}(C_j)
  where R is hash-derived and the canceler is
      C_j = (B_1 V_{start_g+idx_j} + R_{g,idx_j}) * (idx_j + 1)^{-1}
  (commit_eval.rs:417-522,627-637). V_i is the WEE25 verifier column for
  position i, satisfying commit * V_i = M_i - B * Z_i for the opening Z_i.
- Offline: commit all blocks, then store the B0-preimage of (commit + B_1)
  (commit_eval.rs:136-179).
- Online, for plaintext x with (k, y) = lut(x) (requires k == x; constant
  plaintexts only, commit_eval.rs:1-2): with c_b0 = s B0 and c_b = s B,
      c_commit = c_b0 * preimage           ~ s (commit + B_1)
      c_lut    = c_commit V_k + c_b Z_k    ~ s M_k + s B_1 V_k
      c_x      = (c_in + c_one) G^{-1}(C_k)
  and since c_in + c_one = s (A_in + A_one) - (x+1) s G, the R/B_1 V/canceler
  terms telescope exactly (the (idx+1)^{-1} scaling matches the (x+1) factor),
  leaving the first m_g columns equal to s (A_out - G y): a fresh BGG encoding
  of the looked-up value under the hash-derived output key
  (commit_eval.rs:331-408).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bgg import BggEncoding, BggPublicKey
from ..commit import MsgMatrixStream, Wee25Commit, Wee25PublicParams
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import FinRingDist, HashSampler
from ..utils.numth import modinv
from .public_lut import PublicLut

PREIMAGE_OF_COMMIT_ID = "preimage_of_commit"


def derive_a_out_matrix(params, row_size: int, hash_key: bytes, gate_id: int) -> PolyMatrix:
    """Hash-derived output pubkey A_out (commit_eval.rs:587-601)."""
    return HashSampler().sample_hash(
        params, hash_key, f"COMMIT_A_OUT_{gate_id}", row_size,
        row_size * params.modulus_digits, FinRingDist(),
    )


def derive_r_g_i_matrix(params, row_size: int, m_b: int, hash_key: bytes,
                        gate_id: int, index: int) -> PolyMatrix:
    """Hash-derived blinding matrix R_{g,i} (commit_eval.rs:603-625)."""
    return HashSampler().sample_hash(
        params, hash_key, f"COMMIT_R_{gate_id}_{index}", row_size, m_b, FinRingDist(),
    )


def derive_canceler_matrix(params, b_1: PolyMatrix, verifier_slice: PolyMatrix,
                           r_g_i: PolyMatrix, idx: int) -> PolyMatrix:
    """(B_1 V_i + R_{g,i}) * (i+1)^{-1} (commit_eval.rs:627-637)."""
    inv = modinv((idx + 1) % params.modulus, params.modulus)
    return (b_1 @ verifier_slice + r_g_i).mul_poly_scalar(Poly.const(params, inv))


@dataclass
class _GateState:
    gate_id: int
    lut_id: int
    one_pubkey: BggPublicKey
    input_pubkey: BggPublicKey


class GateStateCollector:
    """Pass-1 PltEvaluator: records gate states, returns hash-derived A_out
    (commit_eval.rs:22-77)."""

    def __init__(self, hash_key: bytes):
        self.hash_key = hash_key
        self.gate_states: dict[int, _GateState] = {}
        self.luts: dict[int, PublicLut] = {}

    def public_lookup(self, params, plt, one, input_pk, gate_id, lut_id):
        self.luts.setdefault(lut_id, plt)
        self.gate_states[gate_id] = _GateState(gate_id, lut_id, one, input_pk)
        return BggPublicKey(
            derive_a_out_matrix(params, input_pk.matrix.nrow, self.hash_key, gate_id), True
        )


@dataclass
class _LutLayout:
    """Global message-vector layout: one contiguous range of rows per LUT
    gate, sorted by gate id (commit_eval.rs:524-574)."""

    start_ids: dict[int, int]           # gate_id -> global start index
    lut_vector_len: int
    padded_len: int                     # next power of tree_base
    gate_ranges: list[tuple[int, int, _GateState]]  # (start, end, state)


def _build_layout(luts: dict[int, PublicLut], gate_states: dict[int, _GateState],
                  tree_base: int) -> _LutLayout:
    start_ids: dict[int, int] = {}
    ranges = []
    cursor = 0
    for gid in sorted(gate_states):
        state = gate_states[gid]
        start_ids[gid] = cursor
        end = cursor + len(luts[state.lut_id])
        ranges.append((cursor, end, state))
        cursor = end
    padded = tree_base
    while padded < cursor:
        padded *= tree_base
    return _LutLayout(start_ids, cursor, padded, ranges)


def _build_msg_blocks(params, scheme: Wee25Commit, pp: Wee25PublicParams,
                      b_1: PolyMatrix, hash_key: bytes, luts, gate_states,
                      ) -> tuple[list[PolyMatrix], _LutLayout]:
    """Materialize the committed message vector (commit_eval.rs:417-522).

    The reference streams blocks lazily through rayon; at test scales the
    table fits in host memory, so blocks are built eagerly once and shared by
    the offline commit and every online opening."""
    assert gate_states, "no LUT gates found for commit evaluator"
    layout = _build_layout(luts, gate_states, scheme.tree_base)
    d, m_b, m_g = scheme.d, scheme.m_b, scheme.m_g
    gadget = PolyMatrix.gadget_matrix(params, d)
    blocks: list[PolyMatrix] = []
    for gidx in range(layout.padded_len):
        if gidx >= layout.lut_vector_len:
            blocks.append(PolyMatrix.zero(params, d, m_b))
            continue
        start, _end, state = next(
            r for r in layout.gate_ranges if r[0] <= gidx < r[1]
        )
        idx, y = luts[state.lut_id].get_checked(params, gidx - start)
        y_poly = Poly.from_elem_to_constant(params, y)
        v_slice = scheme.verifier(
            params, layout.padded_len, range(start + idx, start + idx + 1), pp
        )
        r_g_i = derive_r_g_i_matrix(params, d, m_b, hash_key, state.gate_id, idx)
        canceler = derive_canceler_matrix(params, b_1, v_slice, r_g_i, idx)
        a_out = derive_a_out_matrix(params, d, hash_key, state.gate_id)
        padded = (a_out - gadget.mul_poly_scalar(y_poly)).concat_columns(
            [PolyMatrix.zero(params, d, m_b - m_g)]
        )
        pubkey_sum = state.input_pubkey.matrix + state.one_pubkey.matrix
        blocks.append(padded + r_g_i - pubkey_sum @ canceler.decompose())
    return blocks, layout


def _derive_b1(params, scheme: Wee25Commit, hash_key: bytes) -> PolyMatrix:
    return HashSampler().sample_hash(
        params, hash_key, "COMMIT_LUT_B1", scheme.d, scheme.m_b, FinRingDist()
    )


class CommitBGGPubKeyPltEvaluator:
    """Offline pass: collect LUT gate states during pubkey evaluation, then
    commit the full message vector and store the B0-preimage of
    (commit + B_1) (commit_eval.rs:77-208)."""

    def __init__(self, params, scheme: Wee25Commit, pp: Wee25PublicParams, hash_key: bytes):
        self.params = params
        self.scheme = scheme
        self.pp = pp
        self.hash_key = hash_key
        self.b_1 = _derive_b1(params, scheme, hash_key)
        self.collector = GateStateCollector(hash_key)

    def public_lookup(self, params, plt, one, input_pk, gate_id, lut_id):
        return self.collector.public_lookup(params, plt, one, input_pk, gate_id, lut_id)

    def commit_all_lut_matrices(self, trap_sampler, b0_trapdoor, b0_matrix: PolyMatrix):
        """Commit every registered table and persist the commitment preimage
        (commit_eval.rs:136-179)."""
        from ..storage import add_lookup_buffer, get_lookup_buffer

        params = self.params
        blocks, _layout = _build_msg_blocks(
            params, self.scheme, self.pp, self.b_1, self.hash_key,
            self.collector.luts, self.collector.gate_states,
        )
        commitment, _cache = self.scheme.commit(
            params, MsgMatrixStream.from_blocks(blocks), self.pp
        )
        target = commitment + self.b_1
        preimage = trap_sampler.preimage(params, b0_trapdoor, b0_matrix, target)
        add_lookup_buffer(get_lookup_buffer([(0, preimage)], PREIMAGE_OF_COMMIT_ID))


class CommitBGGEncodingPltEvaluator:
    """Online pass: re-derive the committed message vector from the circuit's
    pubkeys, recover c_commit ~ s (commit + B_1) through the stored preimage,
    and answer each lookup with a verifier/opening pair plus the canceler
    (commit_eval.rs:211-408).

    The commit cache is recomputed here instead of loaded from storage (the
    commitment is deterministic given pp and the message blocks); at scale the
    reference persists it (CommitCache::load) and that is the same
    optimization hook for a later round."""

    def __init__(self, params, scheme: Wee25Commit, pp: Wee25PublicParams,
                 hash_key: bytes, circuit, one_pubkey: BggPublicKey,
                 input_pubkeys: list[BggPublicKey], c_b0: PolyMatrix,
                 c_b: PolyMatrix, dir_path):
        from ..storage import read_matrix_from_multi_batch

        self.params = params
        self.scheme = scheme
        self.pp = pp
        self.hash_key = hash_key
        self.b_1 = _derive_b1(params, scheme, hash_key)
        self.c_b = c_b
        collector = GateStateCollector(hash_key)
        circuit.eval(params, one_pubkey, input_pubkeys, plt_evaluator=collector)
        self.luts = dict(collector.luts)
        self.gate_states = dict(collector.gate_states)
        self.blocks, self.layout = _build_msg_blocks(
            params, scheme, pp, self.b_1, hash_key, self.luts, self.gate_states
        )
        self.stream = MsgMatrixStream.from_blocks(self.blocks)
        _commitment, self.cache = scheme.commit(params, self.stream, pp)
        preimage = read_matrix_from_multi_batch(
            params, dir_path, PREIMAGE_OF_COMMIT_ID, 0
        )
        assert preimage is not None, "preimage_of_commit not found in storage"
        self.c_commit = c_b0 @ preimage

    def public_lookup(self, params, plt, one, input_enc, gate_id, lut_id):
        assert input_enc.plaintext is not None, (
            "BGG encoding must reveal plaintext for public lookup"
        )
        x = input_enc.plaintext.const_value()
        got = plt.get(params, x)
        assert got is not None, f"{x} not found in LUT for gate {gate_id}"
        k, y = got
        y_poly = Poly.from_elem_to_constant(params, y)
        pos = self.layout.start_ids[gate_id] + k
        scheme, pp = self.scheme, self.pp
        opening = scheme.open(params, self.stream, range(pos, pos + 1), pp, self.cache)
        v_slice = scheme.verifier(params, self.layout.padded_len, range(pos, pos + 1), pp)
        r_g_i = derive_r_g_i_matrix(
            params, input_enc.pubkey.matrix.nrow, scheme.m_b, self.hash_key, gate_id, k
        )
        canceler = derive_canceler_matrix(params, self.b_1, v_slice, r_g_i, k)
        c_lut = self.c_commit @ v_slice + self.c_b @ opening
        c_x = (input_enc.vector + one.vector) @ canceler.decompose()
        c_out = (c_lut + c_x).slice_columns(0, scheme.m_g)
        a_out = derive_a_out_matrix(
            params, input_enc.pubkey.matrix.nrow, self.hash_key, gate_id
        )
        return BggEncoding(c_out, BggPublicKey(a_out, True), y_poly)
