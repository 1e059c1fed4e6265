"""Polynomial-matrix algebra over the DCRT ring: uint32[L, r, c, n] arrays.

Replacement for the reference's `PolyMatrix` trait + CPU/GPU backends
(reference src/matrix/mod.rs:45-379, matrix/dcrt_poly.rs,
matrix/gpu_dcrt_poly.rs). Block algebra, gadget matrix, G^{-1} decomposition
(big and per-tower "small"), tensor/concat/slice, and the exact int8-digit
matmul.

All bulk math is jitted device code; the class is a thin host-side wrapper
holding (data, fmt, params).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_add, ew_mul, ew_mul_mont_const, ew_neg, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.element import FinRingElem
from ..ring.ntt import ntt_fwd, ntt_inv
from ..ring.params import RingParams
from ..ring.poly import COEFF, EVAL, Poly, residues_from_int

_MAGIC = b"MXTM"


@jax.jit
def _modulus_switch_u32(coeff_data, int_parts, frac_parts, new_modulus, moduli):
    """round(x * P / q) mod P from CRT residues, re-embedded per limb.

    coeff_data: uint32[L, r, c, n]; int_parts: uint64[L] = floor(e_t P / q)
    mod P; frac_parts: float64[L] = frac(e_t P / q); new_modulus: uint64 P.
    Integer parts accumulate exactly mod P in uint64 (each term < 2^62 after
    per-term reduction); fractional parts accumulate in float64.
    """
    r = coeff_data.astype(jnp.uint64)  # [L, r, c, n]
    shape = (-1,) + (1,) * (coeff_data.ndim - 1)
    terms = (r * (int_parts.reshape(shape) % new_modulus)) % new_modulus
    hi = jnp.sum(terms, axis=0) % new_modulus  # [r, c, n]
    fr = jnp.sum(r.astype(jnp.float64) * frac_parts.reshape(shape), axis=0)
    fr_floor = jnp.floor(fr)
    carry = (fr_floor.astype(jnp.uint64) + jnp.where(fr - fr_floor >= 0.5, 1, 0).astype(jnp.uint64)) % new_modulus
    v = (hi + carry) % new_modulus  # [r, c, n]
    return (v[None] % moduli.astype(jnp.uint64).reshape(shape)).astype(jnp.uint32)


@dataclass(frozen=True)
class PolyMatrix:
    data: jnp.ndarray  # uint32[L, nrow, ncol, n]
    fmt: str
    params: RingParams

    # ------------------------------------------------------------ construct

    @staticmethod
    def zero(params: RingParams, nrow: int, ncol: int, fmt: str = EVAL) -> "PolyMatrix":
        return PolyMatrix(
            jnp.zeros((params.crt_depth, nrow, ncol, params.n), dtype=jnp.uint32), fmt, params
        )

    @staticmethod
    def identity(params: RingParams, size: int, scalar: Poly | None = None) -> "PolyMatrix":
        if scalar is None:
            diag = Poly.one(params)
        else:
            diag = scalar.to_eval()
        data = jnp.zeros((params.crt_depth, size, size, params.n), dtype=jnp.uint32)
        idx = jnp.arange(size)
        data = data.at[:, idx, idx, :].set(diag.data[:, None, :])
        return PolyMatrix(data, EVAL, params)

    @staticmethod
    def from_polys(params: RingParams, rows: list[list[Poly]]) -> "PolyMatrix":
        nrow = len(rows)
        ncol = len(rows[0])
        fmts = {p.fmt for r in rows for p in r}
        fmt = EVAL if len(fmts) > 1 else fmts.pop()
        arrs = [
            [(p.to_eval() if fmt == EVAL else p).data for p in row] for row in rows
        ]
        data = jnp.stack([jnp.stack(r, axis=1) for r in arrs], axis=1)
        assert data.shape == (params.crt_depth, nrow, ncol, params.n)
        return PolyMatrix(data, fmt, params)

    @staticmethod
    def from_poly_row(params: RingParams, polys: list[Poly]) -> "PolyMatrix":
        return PolyMatrix.from_polys(params, [polys])

    @staticmethod
    def from_poly_column(params: RingParams, polys: list[Poly]) -> "PolyMatrix":
        return PolyMatrix.from_polys(params, [[p] for p in polys])

    @staticmethod
    def scaled_unit_column_vector(params, size: int, index: int, scalar: Poly) -> "PolyMatrix":
        assert index < size, "unit column index must be in range"
        data = jnp.zeros((params.crt_depth, size, 1, params.n), dtype=jnp.uint32)
        data = data.at[:, index, 0, :].set(scalar.to_eval().data)
        return PolyMatrix(data, EVAL, params)

    @staticmethod
    def unit_column_vector(params, size: int, index: int) -> "PolyMatrix":
        return PolyMatrix.scaled_unit_column_vector(params, size, index, Poly.one(params))

    @staticmethod
    def gadget_matrix(params: RingParams, size: int) -> "PolyMatrix":
        """G = I_size tensor g, g the k-digit gadget row vector (EVAL form).

        Entries are constant polys with residues `np_gadget_res[idx, limb]`
        (reference matrix/mod.rs:gadget_matrix + dcrt_poly.rs:441). Cached per
        (params, size): G sits on every BGG scalar-mul path, and rebuilding
        the einsum per call dominated protocol profiles."""
        cache = params._tables.setdefault("gadget_matrix_cache", {})
        if size not in cache:
            k = params.modulus_digits
            gv = jnp.asarray(params.np_gadget_res)  # [k, L]
            eye = jnp.eye(size, dtype=jnp.uint32)
            # out[l, i, j*k+m, slot] = eye[i, j] * gv[m, l]
            out = jnp.einsum("ij,ml->lijm", eye, gv).reshape(
                params.crt_depth, size, size * k
            )
            data = jnp.broadcast_to(out[..., None], out.shape + (params.n,))
            cache[size] = PolyMatrix(data.astype(jnp.uint32), EVAL, params)
        return cache[size]

    @staticmethod
    def small_gadget_matrix(params: RingParams, size: int) -> "PolyMatrix":
        """I_size tensor (1, b, ..., b^{dpt-1}) of constant polys."""
        dpt = params.digits_per_tower
        gv = jnp.asarray(params.np_small_gadget_res)  # [dpt, L]
        eye = jnp.eye(size, dtype=jnp.uint32)
        out = jnp.einsum("ij,ml->lijm", eye, gv).reshape(params.crt_depth, size, size * dpt)
        data = jnp.broadcast_to(out[..., None], out.shape + (params.n,))
        return PolyMatrix(data.astype(jnp.uint32), EVAL, params)

    # ------------------------------------------------------------- shape ops

    @property
    def nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ncol(self) -> int:
        return self.data.shape[2]

    def row_size(self) -> int:
        return self.nrow

    def col_size(self) -> int:
        return self.ncol

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrow, self.ncol)

    def entry(self, i: int, j: int) -> Poly:
        return Poly(self.data[:, i, j, :], self.fmt, self.params)

    def get_row(self, i: int) -> list[Poly]:
        return [self.entry(i, j) for j in range(self.ncol)]

    def get_column(self, j: int) -> list[Poly]:
        return [self.entry(i, j) for i in range(self.nrow)]

    def block_entries(self, rows: range, cols: range) -> list[list[Poly]]:
        return [[self.entry(i, j) for j in cols] for i in rows]

    def slice(self, row_start: int, row_end: int, col_start: int, col_end: int) -> "PolyMatrix":
        return PolyMatrix(
            self.data[:, row_start:row_end, col_start:col_end, :], self.fmt, self.params
        )

    def slice_rows(self, start: int, end: int) -> "PolyMatrix":
        return self.slice(start, end, 0, self.ncol)

    def slice_columns(self, start: int, end: int) -> "PolyMatrix":
        return self.slice(0, self.nrow, start, end)

    def transpose(self) -> "PolyMatrix":
        return PolyMatrix(jnp.swapaxes(self.data, 1, 2), self.fmt, self.params)

    def concat_columns(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        mats = [self] + list(others)
        fmt = self.fmt
        datas = [(m if m.fmt == fmt else m._convert(fmt)).data for m in mats]
        return PolyMatrix(jnp.concatenate(datas, axis=2), fmt, self.params)

    def concat_rows(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        mats = [self] + list(others)
        fmt = self.fmt
        datas = [(m if m.fmt == fmt else m._convert(fmt)).data for m in mats]
        return PolyMatrix(jnp.concatenate(datas, axis=1), fmt, self.params)

    def concat_diag(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        mats = [self] + list(others)
        fmt = self.fmt
        R = sum(m.nrow for m in mats)
        C = sum(m.ncol for m in mats)
        data = jnp.zeros((self.params.crt_depth, R, C, self.params.n), dtype=jnp.uint32)
        r0 = c0 = 0
        for m in mats:
            md = (m if m.fmt == fmt else m._convert(fmt)).data
            data = data.at[:, r0 : r0 + m.nrow, c0 : c0 + m.ncol, :].set(md)
            r0 += m.nrow
            c0 += m.ncol
        return PolyMatrix(data, fmt, self.params)

    def tensor(self, other: "PolyMatrix") -> "PolyMatrix":
        """Kronecker product with pointwise poly products (EVAL form)."""
        a = self.to_eval().data
        b = other.to_eval().data
        jt = self.params.jt
        x = a[:, :, None, :, None, :]
        y = b[:, None, :, None, :, :]
        z = ew_mul(
            jnp.broadcast_to(x, (a.shape[0], a.shape[1], b.shape[1], a.shape[2], b.shape[2], a.shape[-1])),
            jnp.broadcast_to(y, (a.shape[0], a.shape[1], b.shape[1], a.shape[2], b.shape[2], a.shape[-1])),
            jt.moduli,
            jt.qinv_neg,
            jt.r2,
        )
        L = a.shape[0]
        return PolyMatrix(
            z.reshape(L, self.nrow * other.nrow, self.ncol * other.ncol, self.params.n),
            EVAL,
            self.params,
        )

    # --------------------------------------------------------------- format

    def _convert(self, fmt: str) -> "PolyMatrix":
        return self.to_eval() if fmt == EVAL else self.to_coeff()

    def to_eval(self) -> "PolyMatrix":
        if self.fmt == EVAL:
            return self
        jt = self.params.jt
        data = ntt_fwd(self.data, jt.psi_rev_mont, jt.moduli, jt.qinv_neg)
        return PolyMatrix(data, EVAL, self.params)

    def to_coeff(self) -> "PolyMatrix":
        if self.fmt == COEFF:
            return self
        jt = self.params.jt
        data = ntt_inv(self.data, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg)
        return PolyMatrix(data, COEFF, self.params)

    # ----------------------------------------------------------- arithmetic

    def _harmonized(self, other: "PolyMatrix"):
        assert self.params is other.params
        if self.fmt == other.fmt:
            return self, other, self.fmt
        return self.to_eval(), other.to_eval(), EVAL

    def __add__(self, other: "PolyMatrix") -> "PolyMatrix":
        a, b, fmt = self._harmonized(other)
        return PolyMatrix(ew_add(a.data, b.data, self.params.jt.moduli), fmt, self.params)

    def __sub__(self, other: "PolyMatrix") -> "PolyMatrix":
        a, b, fmt = self._harmonized(other)
        return PolyMatrix(ew_sub(a.data, b.data, self.params.jt.moduli), fmt, self.params)

    def __neg__(self) -> "PolyMatrix":
        return PolyMatrix(ew_neg(self.data, self.params.jt.moduli), self.fmt, self.params)

    def __matmul__(self, other: "PolyMatrix") -> "PolyMatrix":
        assert self.ncol == other.nrow, (self.shape, other.shape)
        a = self.to_eval().data
        b = other.to_eval().data
        jt = self.params.jt
        out = zq_matmul(a, b, jt.moduli, jt.qinv_neg, jt.combine_pows_mont, jt.sign_corr_pows)
        return PolyMatrix(out, EVAL, self.params)

    def __mul__(self, other):
        """Matrix * matrix, matrix * Poly (scalar), or matrix * int/FinRingElem."""
        if isinstance(other, PolyMatrix):
            return self @ other
        if isinstance(other, Poly):
            return self.mul_poly_scalar(other)
        if isinstance(other, FinRingElem):
            return self.mul_int_scalar(other.value)
        if isinstance(other, int):
            return self.mul_int_scalar(other)
        return NotImplemented

    def mul_poly_scalar(self, scalar: Poly) -> "PolyMatrix":
        a = self.to_eval()
        s = scalar.to_eval()
        jt = self.params.jt
        out = ew_mul(a.data, s.data[:, None, None, :], jt.moduli, jt.qinv_neg, jt.r2)
        return PolyMatrix(out, EVAL, self.params)

    def mul_int_scalar(self, value: int) -> "PolyMatrix":
        res = residues_from_int(self.params, value).astype(np.uint64)
        mont = (res << 32) % self.params.np_moduli.astype(np.uint64)
        jt = self.params.jt
        out = ew_mul_mont_const(
            self.data, jnp.asarray(mont.astype(np.uint32)), jt.moduli, jt.qinv_neg
        )
        return PolyMatrix(out, self.fmt, self.params)

    def __eq__(self, other) -> bool:
        if not isinstance(other, PolyMatrix) or self.params is not other.params:
            return NotImplemented
        if self.shape != other.shape:
            return False
        a, b, _ = self._harmonized(other)
        return bool(jnp.array_equal(a.data, b.data))

    def __hash__(self):
        return id(self)

    # --------------------------------------------------------- decomposition

    def decompose(self) -> "PolyMatrix":
        """G^{-1}: [r, c] -> [r*k, c] with per-tower digits (reference
        matrix/dcrt_poly.rs:134-165)."""
        p = self.params
        out = digit_decompose(
            self.to_coeff().data,
            p.jt.moduli,
            p.jt.digit_masks,
            base_bits=p.base_bits,
            dpt=p.digits_per_tower,
            towers=p.crt_depth,
        )
        return PolyMatrix(out, COEFF, p)

    def small_decompose(self) -> "PolyMatrix":
        """Per-tower G^{-1} for small-norm entries: [r, c] -> [r*dpt, c]."""
        p = self.params
        out = digit_decompose(
            self.to_coeff().data,
            p.jt.moduli,
            p.jt.digit_masks,
            base_bits=p.base_bits,
            dpt=p.digits_per_tower,
            towers=1,
        )
        return PolyMatrix(out, COEFF, p)

    def get_column_matrix_decompose(self, j: int) -> "PolyMatrix":
        return self.slice_columns(j, j + 1).decompose()

    def mul_decompose(self, other: "PolyMatrix") -> "PolyMatrix":
        """self @ G^{-1}(other): self [*, d*k], other [d, m] -> [*, m].

        With MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH > 0, G^{-1}(other) is never
        materialized whole: column chunks decompose + multiply + concat
        (reference dcrt_poly.rs:248-274 column loop; digit decomposition is
        per-entry, so chunking is exact)."""
        from .. import config

        k = self.params.modulus_digits
        assert self.ncol == other.nrow * k, (self.shape, other.shape, k)
        w = config.mul_decompose_column_chunk_width()
        if w <= 0 or other.ncol <= w:
            return self @ other.decompose()
        outs = [
            self @ other.slice_columns(s, min(s + w, other.ncol)).decompose()
            for s in range(0, other.ncol, w)
        ]
        return outs[0] if len(outs) == 1 else outs[0].concat_columns(outs[1:])

    def mul_decompose_small(self, other: "PolyMatrix") -> "PolyMatrix":
        dpt = self.params.digits_per_tower
        assert self.ncol == other.nrow * dpt
        return self @ other.small_decompose()

    def mul_tensor_identity(self, other: "PolyMatrix", identity_size: int) -> "PolyMatrix":
        """self @ (I_identity_size tensor other) without materializing it."""
        assert self.ncol == other.nrow * identity_size
        w = other.nrow
        slices = [
            self.slice_columns(i * w, (i + 1) * w) @ other for i in range(identity_size)
        ]
        return slices[0].concat_columns(slices[1:])

    def mul_tensor_identity_decompose(self, other: "PolyMatrix", identity_size: int) -> "PolyMatrix":
        k = self.params.modulus_digits
        assert self.ncol == other.nrow * identity_size * k
        w = other.nrow * k
        slices = [
            self.slice_columns(i * w, (i + 1) * w).mul_decompose(other)
            for i in range(identity_size)
        ]
        return slices[0].concat_columns(slices[1:])

    def modulus_switch(self, new_modulus: int) -> "PolyMatrix":
        """Round-scale all coefficients from q to new_modulus.

        Device path (new_modulus < 2^32): OpenFHE-style CRT scale-and-round
        (reference delegates to OpenFHE's ScaleAndRound; matrix/mod.rs
        modulus_switch). round(x*P/q) for x = sum_t r_t e_t - m q splits
        e_t*P/q = I_t + f_t into an exact integer part accumulated mod P in
        uint64 and a float64 fractional sum (abs error ~L*2^-23 per coeff —
        the same double-precision approximation OpenFHE uses; a boundary case
        needs the true fraction within ~2^-19 of 1/2). Larger targets fall
        back to the exact host BigInt path.
        """
        p = self.params
        q = p.modulus
        if new_modulus < (1 << 32):
            switched = _modulus_switch_u32(
                self.to_coeff().data,
                p.jt.ms_int_parts(new_modulus),
                p.jt.ms_frac_parts(new_modulus),
                jnp.uint64(new_modulus),
                p.jt.moduli,
            )
            return PolyMatrix(switched, COEFF, p)
        arr = np.asarray(self.to_coeff().data)
        rows = []
        for i in range(self.nrow):
            row = []
            for j in range(self.ncol):
                coeffs = [p.reconstruct_coeff(arr[:, i, j, t]) for t in range(p.n)]
                switched = [(c * new_modulus + q // 2) // q % new_modulus for c in coeffs]
                row.append(Poly.from_int_coeffs(p, switched))
            rows.append(row)
        return PolyMatrix.from_polys(p, rows)

    # ---------------------------------------------------------------- serde

    def to_compact_bytes(self) -> bytes:
        p = self.params
        arr = np.asarray(self.data)
        header = _MAGIC + struct.pack(
            "<BBIIIIHB",
            1,
            0 if self.fmt == COEFF else 1,
            self.nrow,
            self.ncol,
            p.n,
            p.crt_depth,
            p.crt_bits,
            p.base_bits,
        )
        return header + arr.tobytes()

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes) -> "PolyMatrix":
        assert raw[:4] == _MAGIC, "bad matrix magic"
        ver, fmt_i, nrow, ncol, n, depth, crt_bits, base_bits = struct.unpack(
            "<BBIIIIHB", raw[4 : 4 + 21]
        )
        assert ver == 1 and n == params.n and depth == params.crt_depth
        arr = np.frombuffer(raw[25:], dtype=np.uint32).reshape(depth, nrow, ncol, n)
        return PolyMatrix(jnp.asarray(arr), COEFF if fmt_i == 0 else EVAL, params)

    def to_packed_bytes(self) -> bytes:
        """Bit-packed serialization: each residue stored in crt_bits bits via
        the native codec (4*8/crt_bits compression vs raw; reference
        MatrixSerde.cu max-coeff-bits packing)."""
        from ..native import pack_u32

        p = self.params
        arr = np.asarray(self.data)
        header = b"MXPK" + struct.pack(
            "<BBIIIIHB",
            1,
            0 if self.fmt == COEFF else 1,
            self.nrow,
            self.ncol,
            p.n,
            p.crt_depth,
            p.crt_bits,
            p.base_bits,
        )
        return header + pack_u32(arr, p.crt_bits)

    @staticmethod
    def from_packed_bytes(params: RingParams, raw: bytes) -> "PolyMatrix":
        from ..native import unpack_u32

        assert raw[:4] == b"MXPK", "bad packed matrix magic"
        ver, fmt_i, nrow, ncol, n, depth, crt_bits, base_bits = struct.unpack(
            "<BBIIIIHB", raw[4:25]
        )
        assert ver == 1 and n == params.n and depth == params.crt_depth
        count = depth * nrow * ncol * n
        arr = unpack_u32(raw[25:], count, crt_bits).reshape(depth, nrow, ncol, n)
        return PolyMatrix(jnp.asarray(arr), COEFF if fmt_i == 0 else EVAL, params)

    def write_to_file(self, dir_path, mat_id: str):
        import os

        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, f"{mat_id}.mxxm"), "wb") as f:
            f.write(self.to_compact_bytes())

    @staticmethod
    def read_from_file(params: RingParams, dir_path, mat_id: str) -> "PolyMatrix":
        import os

        with open(os.path.join(dir_path, f"{mat_id}.mxxm"), "rb") as f:
            return PolyMatrix.from_compact_bytes(params, f.read())
