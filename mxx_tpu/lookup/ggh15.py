"""GGH15-chain public lookup-table evaluators over BGG+ wires.

Build of the reference GGH15 lookup
(/root/reference/src/lookup/ggh15/{pubkey.rs,encoding.rs}; SURVEY.md A.2).

Structure: two trapdoors (B0, T0), (B1, T1). Per LUT entry x -> (row k, y), a
B1-preimage keyed by the INPUT value x

    L_x = B1^{-1}( W_id + W_gy G^{-1}(G y) + W_v V_k + W_vx (V_k x) ),

with hash-derived blocks W_id, W_gy, W_v, W_vx (d x m_g) per LUT and
V_k = HashDecomposed("ggh15_lut_v_idx_{lut}_{k}") per output row. Keying the
aux preimage by x (while V stays keyed by k) makes ARBITRARY x -> (k, y)
tables exact: the W_vx legs telescope because both sides use the same x
(the reference keys its aux by k and uses idx_poly = k offline vs the runtime
x online, pubkey.rs:1559-1567 + encoding.rs:246, so its algebra only closes
for tables with x == k — every reference GGH15 test uses such a table).
Per gate g with input pubkey A_z, a fresh ternary secret s_g and five
B0-preimages:

    P1     = B0^{-1}( s_g B1 + e )
    P2_id  = B0^{-1}( s_g W_id + A_out + e )        A_out = Hash("ggh15_gate_a_out_{g}")
    P2_gy  = B0^{-1}( s_g W_gy - G + e )
    P2_v   = B0^{-1}( s_g W_v - A_z G^{-1}(U_g) + e )  U_g = Hash("ggh15_lut_u_g_matrix_{g}")
    P2_vx  = B0^{-1}( s_g W_vx + U_g + e )

Online, with c_b0 ~ s B0 and input wire (c_z, A_z, x):

    c_out = c_b0 [ P2_id + P2_gy G^{-1}(G y) + P2_v V_k + P2_vx (V_k x) - P1 L_x ]
            + c_z G^{-1}(U_g) V_k
          ~ s A_out - y (s G),

an encoding of y under A_out (the s_g.W terms telescope through L_x, and the
U_g terms cancel between P2_v/P2_vx and the c_z leg).

All artifacts persist under a deterministic checkpoint prefix, column-chunked,
and `sample_aux_matrices` resumes partially-sampled chains
(reference pubkey.rs:772,1244-1272). The online reduction is wave-pipelined
(reference encoding.rs:50-140): it walks stored column chunks, and because XLA
dispatch is asynchronous the host read of chunk N+1 overlaps the device
multiply of chunk N.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import (
    FinRingDist,
    GaussDist,
    HashSampler,
    TernaryDist,
    Trapdoor,
    TrapdoorSampler,
    UniformSampler,
)
from ..storage import (
    add_lookup_buffer,
    get_lookup_buffer,
    get_storage_system,
    read_bytes_from_multi_batch,
    read_matrix_from_multi_batch,
)
from ..utils.tracing import span
from .public_lut import PublicLut


# ------------------------------------------------------------ column chunking


def column_chunk_width(total_cols: int) -> int:
    assert total_cols > 0
    return min(total_cols, max(config.aux_sampling_chunk_width(), 1))


def column_chunk_count(total_cols: int) -> int:
    return -(-total_cols // column_chunk_width(total_cols))


def column_chunk_bounds(total_cols: int, chunk_idx: int) -> tuple[int, int]:
    w = column_chunk_width(total_cols)
    start = chunk_idx * w
    assert start < total_cols
    return start, min(total_cols - start, w)


def chunk_prefix(id_prefix: str, chunk_idx: int) -> str:
    return f"{id_prefix}_chunk{chunk_idx}"


def store_matrix_chunked(matrix: PolyMatrix, id_prefix: str):
    total = matrix.ncol
    for ci in range(column_chunk_count(total)):
        s, ln = column_chunk_bounds(total, ci)
        add_lookup_buffer(
            get_lookup_buffer([(0, matrix.slice_columns(s, s + ln))], chunk_prefix(id_prefix, ci))
        )


def read_matrix_chunked(params, dir_path, id_prefix: str, total_cols: int) -> PolyMatrix | None:
    chunks = []
    for ci in range(column_chunk_count(total_cols)):
        m = read_matrix_from_multi_batch(params, dir_path, chunk_prefix(id_prefix, ci), 0)
        if m is None:
            return None
        chunks.append(m)
    return chunks[0] if len(chunks) == 1 else chunks[0].concat_columns(chunks[1:])


def chunks_complete(storage, id_prefix: str, total_cols: int) -> bool:
    return all(
        storage.has_index(chunk_prefix(id_prefix, ci), 0)
        for ci in range(column_chunk_count(total_cols))
    )


# ------------------------------------------------------------------ evaluators


@dataclass
class _GateState:
    lut_id: int
    input_pubkey: PolyMatrix


class GGH15BGGPubKeyPltEvaluator:
    """Offline (pubkey-path) evaluator with checkpoint-prefix resume."""

    def __init__(
        self,
        hash_key: bytes,
        d: int,
        trapdoor_sigma: float,
        error_sigma: float,
        dir_path,
        seed: int | None = None,
        mesh=None,
    ):
        self.hash_key = hash_key
        self.d = d
        self.trapdoor_sigma = trapdoor_sigma
        self.error_sigma = error_sigma
        self.mesh = mesh  # offline preimage sampling shards over mesh 'col' axis
        self.dir_path = Path(dir_path)
        self.lut_state: dict[int, PublicLut] = {}
        self.gate_state: dict[int, _GateState] = {}
        self._uniform = UniformSampler(seed)
        self._hash = HashSampler()

    # ---- deterministic ids

    def checkpoint_prefix(self, params) -> str:
        key_digest = hashlib.sha256(self.hash_key).hexdigest()[:16]
        return (
            f"ggh15_aux_n{params.n}_L{params.crt_depth}_crt{params.crt_bits}"
            f"_b{params.base_bits}_d{self.d}_ts{self.trapdoor_sigma}"
            f"_es{self.error_sigma}_ins0_key{key_digest}"
        )

    def _lut_aux_id(self, params, lut_id: int, x: int) -> str:
        # keyed by the entry INPUT x, not the output row k: see module doc
        return f"{self.checkpoint_prefix(params)}_lut_aux_{lut_id}_in{x}"

    def _gate_id_prefix(self, params, stage: str, gate_id: int) -> str:
        return f"{self.checkpoint_prefix(params)}_preimage_{stage}_{gate_id}"

    def _derive_w_block(self, params, lut_id: int, tag: str) -> PolyMatrix:
        m_g = self.d * params.modulus_digits
        return self._hash.sample_hash(
            params, self.hash_key, f"ggh15_w_{lut_id}_{tag}", self.d, m_g, FinRingDist()
        )

    def _a_out(self, params, gate_id: int) -> PolyMatrix:
        m_g = self.d * params.modulus_digits
        return self._hash.sample_hash(
            params, self.hash_key, f"ggh15_gate_a_out_{gate_id}", self.d, m_g, FinRingDist()
        )

    def _u_g(self, params, gate_id: int) -> PolyMatrix:
        m_g = self.d * params.modulus_digits
        return self._hash.sample_hash(
            params, self.hash_key, f"ggh15_lut_u_g_matrix_{gate_id}", self.d, m_g, FinRingDist()
        )

    def _v_idx(self, params, lut_id: int, k: int) -> PolyMatrix:
        m_g = self.d * params.modulus_digits
        return self._hash.sample_hash(
            params, self.hash_key, f"ggh15_lut_v_idx_{lut_id}_{k}", self.d, m_g, FinRingDist()
        ).decompose()

    def _error(self, params, nrow: int, ncol: int) -> PolyMatrix:
        if self.error_sigma <= 0.0:
            return PolyMatrix.zero(params, nrow, ncol)
        return self._uniform.sample_uniform(params, nrow, ncol, GaussDist(self.error_sigma))

    # ---- PltEvaluator surface (records state, returns hash-derived A_out)

    def public_lookup(self, params, plt, one, input_pk: BggPublicKey, gate_id, lut_id):
        self.lut_state.setdefault(lut_id, plt)
        self.gate_state[gate_id] = _GateState(lut_id, input_pk.matrix)
        return BggPublicKey(self._a_out(params, gate_id), True)

    # ---- trapdoor checkpoints

    def _load_trapdoor(self, params, name: str):
        cp = self.checkpoint_prefix(params)
        mat = read_matrix_from_multi_batch(params, self.dir_path, f"{cp}_{name}", 0)
        td_raw = read_bytes_from_multi_batch(self.dir_path, f"{cp}_{name}_trapdoor", 0)
        if mat is None or td_raw is None:
            return None
        return Trapdoor.from_compact_bytes(params, td_raw), mat

    def _store_trapdoor(self, params, name: str, trapdoor: Trapdoor, matrix: PolyMatrix):
        cp = self.checkpoint_prefix(params)
        add_lookup_buffer(get_lookup_buffer([(0, matrix)], f"{cp}_{name}"))
        from ..storage import get_lookup_buffer_bytes

        add_lookup_buffer(
            get_lookup_buffer_bytes([(0, trapdoor.to_compact_bytes())], f"{cp}_{name}_trapdoor")
        )

    def load_b0_matrix_checkpoint(self, params) -> PolyMatrix | None:
        cp = self.checkpoint_prefix(params)
        return read_matrix_from_multi_batch(params, self.dir_path, f"{cp}_b0", 0)

    # ---- offline sampling

    def sample_aux_matrices(self, params):
        with span("ggh15.sample_aux_matrices", luts=len(self.lut_state),
                  gates=len(self.gate_state)):
            return self._sample_aux_matrices(params)

    def _sample_aux_matrices(self, params):
        storage = get_storage_system()
        trap_sampler = TrapdoorSampler(params, self.trapdoor_sigma)
        d = self.d
        m_g = d * params.modulus_digits

        loaded0 = self._load_trapdoor(params, "b0")
        if loaded0 is None:
            b0_trapdoor, b0_matrix = trap_sampler.trapdoor(params, d)
            self._store_trapdoor(params, "b0", b0_trapdoor, b0_matrix)
        else:
            b0_trapdoor, b0_matrix = loaded0
        loaded1 = self._load_trapdoor(params, "b1")
        if loaded1 is None:
            b1_trapdoor, b1_matrix = trap_sampler.trapdoor(params, d)
            self._store_trapdoor(params, "b1", b1_trapdoor, b1_matrix)
        else:
            b1_trapdoor, b1_matrix = loaded1

        gadget = PolyMatrix.gadget_matrix(params, d)

        # LUT preimages under B1 (resume row-by-row); pending entries share
        # the B1 trapdoor, so they sample as ONE mesh-sharded batched program
        # (reference multi-GPU entry fan-out, ggh15/pubkey_gpu.rs)
        for lut_id, plt in list(self.lut_state.items()):
            w_id = self._derive_w_block(params, lut_id, "block_identity")
            w_gy = self._derive_w_block(params, lut_id, "block_gy")
            w_v = self._derive_w_block(params, lut_id, "block_v")
            w_vx = self._derive_w_block(params, lut_id, "block_vx")
            aux_ids, targets = [], []
            for x, (k, y) in plt.entries(params):
                aux_id = self._lut_aux_id(params, lut_id, x)
                if chunks_complete(storage, aux_id, m_g):
                    continue
                y_poly = Poly.from_elem_to_constant(params, y)
                x_poly = Poly.const(params, x)
                v_k = self._v_idx(params, lut_id, k)
                gy_dec = gadget.mul_poly_scalar(y_poly).decompose()
                aux_ids.append(aux_id)
                targets.append(
                    w_id
                    + w_gy @ gy_dec
                    + w_v @ v_k
                    + w_vx @ v_k.mul_poly_scalar(x_poly)
                )
            if targets:
                preimages = trap_sampler.preimage_batched_chunked(
                    params, b1_trapdoor, b1_matrix, targets, mesh=self.mesh
                )
                for aux_id, l_x in zip(aux_ids, preimages):
                    store_matrix_chunked(l_x, aux_id)
            self.lut_state.pop(lut_id)

        # gate preimages under B0 (resume stage-by-stage)
        for gate_id, state in list(self.gate_state.items()):
            lut_id = state.lut_id
            w_id = self._derive_w_block(params, lut_id, "block_identity")
            w_gy = self._derive_w_block(params, lut_id, "block_gy")
            w_v = self._derive_w_block(params, lut_id, "block_v")
            w_vx = self._derive_w_block(params, lut_id, "block_vx")
            u_g = self._u_g(params, gate_id)
            a_out = self._a_out(params, gate_id)
            s_g = self._uniform.sample_uniform(params, d, d, TernaryDist())

            stages = {
                "gate1": s_g @ b1_matrix + self._error(params, d, b1_matrix.ncol),
                "gate2_identity": s_g @ w_id + a_out + self._error(params, d, m_g),
                "gate2_gy": s_g @ w_gy - gadget + self._error(params, d, m_g),
                "gate2_v": s_g @ w_v - state.input_pubkey @ u_g.decompose()
                + self._error(params, d, m_g),
                "gate2_vx": s_g @ w_vx + u_g + self._error(params, d, m_g),
            }
            # the five stages share the B0 trapdoor: one mesh-sharded batch
            prefixes, targets = [], []
            for stage, target in stages.items():
                prefix = self._gate_id_prefix(params, stage, gate_id)
                if chunks_complete(storage, prefix, target.ncol):
                    continue
                prefixes.append(prefix)
                targets.append(target)
            if targets:
                preimages = trap_sampler.preimage_batched_chunked(
                    params, b0_trapdoor, b0_matrix, targets, mesh=self.mesh
                )
                for prefix, pre in zip(prefixes, preimages):
                    store_matrix_chunked(pre, prefix)
            self.gate_state.pop(gate_id)


class GGH15BGGPolyEncodingPltEvaluator:
    """Online GGH15 lookup over packed slot-wise encodings (reference
    ggh15/poly_encoding.rs): the stored chain is slot-independent; each slot
    decodes with its own c_b0 row and its own LUT row, and the slot rows are
    restacked under the shared hash-derived output pubkey."""

    def __init__(self, hash_key: bytes, dir_path, checkpoint_prefix: str, params,
                 c_b0_rows):
        self.scalar = GGH15BGGEncodingPltEvaluator(
            hash_key, dir_path, checkpoint_prefix, params, None
        )
        self.c_b0_rows = c_b0_rows  # S x m_b

    def public_lookup(self, params, plt, one, input_enc, gate_id, lut_id):
        from ..bgg.encoding import BggEncoding
        from ..bgg.poly_encoding import BggPolyEncoding

        assert input_enc.plaintexts is not None
        assert self.c_b0_rows.nrow == input_enc.num_slots, (
            f"c_b0_rows has {self.c_b0_rows.nrow} rows for "
            f"{input_enc.num_slots} slots"
        )
        rows = []
        out_pk = None
        out_pts = []
        for s in range(input_enc.num_slots):
            self.scalar.c_b0 = self.c_b0_rows.slice_rows(s, s + 1)
            enc = BggEncoding(input_enc.vector(s), input_enc.pubkey, input_enc.plaintext(s))
            got = self.scalar.public_lookup(params, plt, None, enc, gate_id, lut_id)
            rows.append(got.vector)
            out_pk = got.pubkey
            out_pts.append(got.plaintext)
        return BggPolyEncoding(rows[0].concat_rows(rows[1:]), out_pk, tuple(out_pts))


class GGH15BGGEncodingPltEvaluator:
    """Online (encoding-path) evaluator reading stored preimage chains."""

    def __init__(self, hash_key: bytes, dir_path, checkpoint_prefix: str, params, c_b0):
        self.hash_key = hash_key
        self.dir_path = Path(dir_path)
        self.cp = checkpoint_prefix
        self.c_b0 = c_b0
        self._hash = HashSampler()

    def _read_chunk(self, params, id_prefix: str, chunk_idx: int) -> PolyMatrix:
        m = read_matrix_from_multi_batch(
            params, self.dir_path, chunk_prefix(id_prefix, chunk_idx), 0
        )
        assert m is not None, f"missing GGH15 artifact {id_prefix} chunk {chunk_idx}"
        return m

    def _mul_chunked_with_rhs(self, params, id_prefix: str, total_cols: int,
                              rhs: PolyMatrix) -> PolyMatrix:
        """sum_ci stored[:, chunk ci] @ rhs[rows of chunk ci, :] without
        materializing the stored matrix (reference
        mul_chunked_checkpoint_with_rhs, encoding.rs:50-140). XLA dispatch is
        asynchronous, so the host read of chunk N+1 overlaps the device
        multiply of chunk N — the wave pipeline."""
        acc = None
        for ci in range(column_chunk_count(total_cols)):
            s, ln = column_chunk_bounds(total_cols, ci)
            term = self._read_chunk(params, id_prefix, ci) @ rhs.slice_rows(s, s + ln)
            acc = term if acc is None else acc + term
        return acc

    def _left_mul_chunked(self, params, left: PolyMatrix, id_prefix: str,
                          total_cols: int) -> PolyMatrix:
        """left @ stored, walking stored column chunks (concat, not sum)."""
        outs = [
            left @ self._read_chunk(params, id_prefix, ci)
            for ci in range(column_chunk_count(total_cols))
        ]
        return outs[0] if len(outs) == 1 else outs[0].concat_columns(outs[1:])

    def public_lookup(self, params, plt, one, input_enc: BggEncoding, gate_id, lut_id):
        assert input_enc.plaintext is not None, "GGH15 lookup input must reveal plaintext"
        x_poly = input_enc.plaintext
        x = x_poly.const_value()
        got = plt.get(params, int(x))
        if got is None:
            raise KeyError(f"{x} not found in LUT {lut_id} for gate {gate_id}")
        k, y = got
        y_poly = Poly.from_elem_to_constant(params, y)
        d = input_enc.pubkey.matrix.nrow
        m_g = d * params.modulus_digits
        m_b = d * (params.modulus_digits + 2)
        hs = self._hash

        a_out = hs.sample_hash(
            params, self.hash_key, f"ggh15_gate_a_out_{gate_id}", d, m_g, FinRingDist()
        )
        u_g_dec = hs.sample_hash(
            params, self.hash_key, f"ggh15_lut_u_g_matrix_{gate_id}", d, m_g, FinRingDist()
        ).decompose()
        v_k = hs.sample_hash(
            params, self.hash_key, f"ggh15_lut_v_idx_{lut_id}_{k}", d, m_g, FinRingDist()
        ).decompose()
        gadget = PolyMatrix.gadget_matrix(params, d)

        gy_dec = gadget.mul_poly_scalar(y_poly).decompose()
        gate1_prefix = f"{self.cp}_preimage_gate1_{gate_id}"
        lut_aux_prefix = f"{self.cp}_lut_aux_{lut_id}_in{int(x)}"

        # wave-pipelined chunked reduction over the stored artifacts
        c = self._left_mul_chunked(
            params, self.c_b0, f"{self.cp}_preimage_gate2_identity_{gate_id}", m_g
        )
        c = c + self.c_b0 @ self._mul_chunked_with_rhs(
            params, f"{self.cp}_preimage_gate2_gy_{gate_id}", m_g, gy_dec
        )
        c = c + self.c_b0 @ self._mul_chunked_with_rhs(
            params, f"{self.cp}_preimage_gate2_v_{gate_id}", m_g, v_k
        )
        c = c + self.c_b0 @ self._mul_chunked_with_rhs(
            params, f"{self.cp}_preimage_gate2_vx_{gate_id}", m_g,
            v_k.mul_poly_scalar(x_poly),
        )
        # P1 @ L_x, output column chunk at a time; each chunk reduces P1's
        # stored inner chunks against the aux chunk's rows
        p1l_chunks = []
        for co in range(column_chunk_count(m_g)):
            l_chunk = self._read_chunk(params, lut_aux_prefix, co)
            p1l_chunks.append(
                self.c_b0 @ self._mul_chunked_with_rhs(params, gate1_prefix, m_b, l_chunk)
            )
        p1l = (
            p1l_chunks[0]
            if len(p1l_chunks) == 1
            else p1l_chunks[0].concat_columns(p1l_chunks[1:])
        )
        c = c - p1l
        c = c + input_enc.vector @ (u_g_dec @ v_k)
        return BggEncoding(c, BggPublicKey(a_out, True), y_poly)
