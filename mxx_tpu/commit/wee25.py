"""WEE25 matrix commitment with trapdoor-sampled openings.

Build of the reference's src/commit/wee25.rs (SURVEY.md A.4). Structure:

- Public params: trapdoor pair (B, T) with B in M^{d x m_b}; Gaussian
  T_bottom in M^{m_b x j2m} (j2m = l*log_q cols, l = tree_base*m_b); and for
  every digit block b = (msg column g, digit row r) a preimage
      T_top_b = B^{-1}( G J_b - W_b T_bottom ),
  where W_b = Hash("wee25_w_block_b") and J_b = G^{-1}(Y_b) with
  Y_b[:, (g', s)] = g_s * g_k * e_i [[g' == g]] (r = i*log_q + k) — chosen so
  that for the digit vector a of any message, sum_b (G J_b) a_b has columns
  X[:, (g, s)] = g_s * msg[:, g].
- Base commit: C = sum_b W_b a_b. Base opening: Z = sum_b T_top_b a_b, giving
  the binding relation  C * T_bottom = X - B * Z.
- Tree: tree_base children commit/open recursively; the opening composes as
  z = z_parent * G^{-1}(V_child) + z_child, and verification is
      C * V = msg_block - B * z  with the recursive verifier V.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import FinRingDist, GaussDist, HashSampler, TrapdoorSampler, UniformSampler

WEE25_PUBLIC_PARAMS_PREFIX = "wee25_public_params"


@dataclass
class Wee25PublicParams:
    b: PolyMatrix
    t_bottom: PolyMatrix  # m_b x j2m
    t_top: dict[int, PolyMatrix]  # block_idx -> m_b x j2m preimage
    hash_key: bytes


class MsgMatrixStream:
    """Lazy window over message blocks (reference wee25.rs:48-110)."""

    def __init__(self, length: int, reader, offset: int = 0):
        self.reader = reader
        self.offset = offset
        self.length = length

    @staticmethod
    def from_blocks(blocks: list[PolyMatrix]) -> "MsgMatrixStream":
        return MsgMatrixStream(len(blocks), lambda rng: blocks[rng.start : rng.stop])

    def __len__(self):
        return self.length

    def slice(self, start: int, end: int) -> "MsgMatrixStream":
        return MsgMatrixStream(end - start, self.reader, self.offset + start)

    def read(self, start: int, end: int) -> list[PolyMatrix]:
        return self.reader(range(self.offset + start, self.offset + end))


class Wee25Commit:
    def __init__(self, secret_size: int, tree_base: int, m_b: int, m_g: int,
                 trapdoor_sigma: float):
        self.d = secret_size
        self.tree_base = tree_base
        self.m_b = m_b
        self.m_g = m_g
        self.trapdoor_sigma = trapdoor_sigma

    @property
    def l(self) -> int:
        return self.tree_base * self.m_b

    def _log_q(self, params) -> int:
        return self.m_g // self.d

    def _j2m_cols(self, params) -> int:
        return self.l * self._log_q(params)

    def checkpoint_prefix(self, params, hash_key: bytes) -> str:
        kd = hashlib.sha256(hash_key).hexdigest()[:16]
        return (
            f"{WEE25_PUBLIC_PARAMS_PREFIX}_n{params.n}_L{params.crt_depth}"
            f"_d{self.d}_tb{self.tree_base}_key{kd}"
        )

    def _w_block(self, params, hash_key: bytes, block_idx: int) -> PolyMatrix:
        tag = b"wee25_w_block_" + block_idx.to_bytes(8, "little")
        return HashSampler().sample_hash(params, hash_key, tag, self.d, self.m_b, FinRingDist())

    def _gadget_row_values(self, params) -> list[int]:
        g = PolyMatrix.gadget_matrix(params, 1)
        return [g.entry(0, t).const_coeff() for t in range(params.modulus_digits)]

    def sample_public_params(self, params, hash_key: bytes, seed: int | None = None,
                             mesh=None) -> Wee25PublicParams:
        """Sample (B, T), T_bottom, and all T_top preimages (wee25.rs:494-760)."""
        log_q = self._log_q(params)
        assert log_q == params.modulus_digits, "m_g must equal d * modulus_digits"
        j2m = self._j2m_cols(params)
        ts = TrapdoorSampler(params, self.trapdoor_sigma, seed=seed)
        trapdoor, b = ts.trapdoor(params, self.d)
        assert b.ncol == self.m_b, (b.ncol, self.m_b)
        t_bottom = UniformSampler(seed).sample_uniform(
            params, self.m_b, j2m, GaussDist(self.trapdoor_sigma)
        )
        g_vals = self._gadget_row_values(params)
        gadget = PolyMatrix.gadget_matrix(params, self.d)
        q = params.modulus
        t_top: dict[int, PolyMatrix] = {}
        pp_size = self.l * self.m_g
        targets: list[PolyMatrix] = []
        for block_idx in range(pp_size):
            g_col = block_idx // self.m_g  # message column g
            r = block_idx % self.m_g
            i_row = r // log_q
            k_dig = r % log_q
            # Y_b: d x j2m with Y[i_row, g_col*log_q + s] = g_s * g_k
            y_rows = []
            for i in range(self.d):
                row = []
                for col in range(j2m):
                    grp, s = divmod(col, log_q)
                    if i == i_row and grp == g_col:
                        row.append(Poly.const(params, g_vals[s] * g_vals[k_dig] % q))
                    else:
                        row.append(Poly.zero(params))
                y_rows.append(row)
            y_b = PolyMatrix.from_polys(params, y_rows)
            j_b = y_b.decompose()  # m_g x j2m
            w_b = self._w_block(params, hash_key, block_idx)
            targets.append(gadget @ j_b - w_b @ t_bottom)
        # every T_top block shares (B, T): one mesh-sharded batched program
        preimages = ts.preimage_batched_chunked(params, trapdoor, b, targets, mesh=mesh)
        for block_idx, pre in enumerate(preimages):
            t_top[block_idx] = pre
        return Wee25PublicParams(b, t_bottom, t_top, hash_key)

    # ------------------------------------------------------------- commit

    def _digits_of(self, msg: PolyMatrix, j: int) -> list[Poly]:
        col = msg.get_column_matrix_decompose(j)  # m_g x 1
        return [col.entry(r, 0) for r in range(self.m_g)]

    def commit_base(self, params, msg: PolyMatrix, pp: Wee25PublicParams) -> PolyMatrix:
        assert msg.shape == (self.d, self.l)
        acc = PolyMatrix.zero(params, self.d, self.m_b)
        for j in range(self.l):
            digits = self._digits_of(msg, j)
            for r in range(self.m_g):
                w = self._w_block(params, pp.hash_key, j * self.m_g + r)
                acc = acc + w.mul_poly_scalar(digits[r])
        return acc

    def commit(self, params, msg_stream: MsgMatrixStream, pp: Wee25PublicParams
               ) -> tuple[PolyMatrix, dict]:
        """Tree commit; returns (commitment, cache of intermediate nodes)."""
        cache: dict[tuple[int, int], PolyMatrix] = {}
        c = self._commit_recursive(params, msg_stream, pp, cache)
        return c, cache

    def _commit_recursive(self, params, stream, pp, cache):
        cols = len(stream)
        if cols == self.tree_base:
            parts = stream.read(0, cols)
            msg = parts[0].concat_columns(parts[1:])
            c = self.commit_base(params, msg, pp)
            cache[(stream.offset, cols)] = c
            return c
        assert cols % self.tree_base == 0
        child = cols // self.tree_base
        commits = [
            self._commit_recursive(params, stream.slice(i * child, (i + 1) * child), pp, cache)
            for i in range(self.tree_base)
        ]
        combined = commits[0].concat_columns(commits[1:])
        c = self.commit_base(params, combined, pp)
        cache[(stream.offset, cols)] = c
        return c

    # --------------------------------------------------------------- open

    def open_base(self, params, msg: PolyMatrix, col_idx: int, pp, is_leaf: bool
                  ) -> PolyMatrix:
        """Z slice for block col_idx: columns [col_idx*m_b*log_q, ...)."""
        log_q = self._log_q(params)
        slice_width = self.m_b * log_q
        col_start = slice_width * col_idx
        acc = PolyMatrix.zero(params, self.m_b, slice_width)
        for j in range(self.l):
            digits = self._digits_of(msg, j)
            for r in range(self.m_g):
                t_part = pp.t_top[j * self.m_g + r].slice_columns(
                    col_start, col_start + slice_width
                )
                acc = acc + t_part.mul_poly_scalar(digits[r])
        if is_leaf:
            return acc @ PolyMatrix.identity(params, self.m_b).decompose()
        return acc

    def open(self, params, msg_stream: MsgMatrixStream, col_range, pp,
             cache: dict) -> PolyMatrix:
        cols = len(msg_stream)
        col_range = col_range if col_range is not None else range(cols)
        outs = [
            self._open_recursive(params, msg_stream, ci, pp, cache) for ci in col_range
        ]
        return outs[0].concat_columns(outs[1:])

    def _open_recursive(self, params, stream, col_idx, pp, cache):
        cols = len(stream)
        if cols == self.tree_base:
            parts = stream.read(0, cols)
            msg = parts[0].concat_columns(parts[1:])
            return self.open_base(params, msg, col_idx, pp, True)
        child = cols // self.tree_base
        child_idx = col_idx % child
        sibling = col_idx // child
        commits = [
            cache[(stream.offset + i * child, child)] for i in range(self.tree_base)
        ]
        commits_msg = commits[0].concat_columns(commits[1:])
        z_prime = self.open_base(params, commits_msg, sibling, pp, False)
        z_child = self._open_recursive(
            params, stream.slice(child * sibling, child * (sibling + 1)), child_idx, pp, cache
        )
        verifier = self._verifier_recursive(params, pp, child, child_idx)
        return z_prime @ verifier.decompose() + z_child

    # ----------------------------------------------------------- verifier

    def _verifier_base(self, params, pp, is_leaf: bool) -> PolyMatrix:
        if is_leaf:
            return pp.t_bottom @ PolyMatrix.identity(params, self.l).decompose()
        return pp.t_bottom

    def _verifier_recursive(self, params, pp, cols, col_idx) -> PolyMatrix:
        if cols == self.tree_base:
            base_last = self._verifier_base(params, pp, True)
            return base_last.slice_columns(self.m_b * col_idx, self.m_b * (col_idx + 1))
        child = cols // self.tree_base
        child_idx = col_idx % child
        sibling = col_idx // child
        child_col = self._verifier_recursive(params, pp, child, child_idx)
        base = self._verifier_base(params, pp, False)
        slice_width = base.ncol // self.tree_base
        sl = base.slice_columns(slice_width * sibling, slice_width * (sibling + 1))
        return sl @ child_col.decompose()

    def verifier(self, params, cols, col_range, pp) -> PolyMatrix:
        col_range = col_range if col_range is not None else range(cols)
        mats = [self._verifier_recursive(params, pp, cols, ci) for ci in col_range]
        return mats[0].concat_columns(mats[1:])

    def verify(self, params, msg: PolyMatrix, commit: PolyMatrix, opening: PolyMatrix,
               col_range, pp) -> bool:
        msg_size = msg.ncol // self.m_b
        v = self.verifier(params, msg_size, col_range, pp)
        target = (
            msg
            if col_range is None
            else msg.slice_columns(self.m_b * col_range.start, self.m_b * col_range.stop)
        )
        lhs = commit @ v
        rhs = target - pp.b @ opening
        return lhs == rhs
