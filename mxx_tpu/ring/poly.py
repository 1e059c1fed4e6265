"""DCRT polynomial: uint32[L, n] residue array with a COEFF/EVAL format flag.

Analog of the reference's `DCRTPoly`
(/root/reference/src/poly/dcrt/poly.rs:24-30) and the `Poly` trait
(/root/reference/src/poly/mod.rs:79-197). The NTT state is an explicit static
flag resolved at trace time (the reference keeps a lazy COEFF/EVAL flag per
GPU matrix, see SURVEY.md A.9); conversions are pure jitted functions.

EVAL format = bit-reversed negacyclic evaluation order produced by
`ring.ntt.ntt_fwd`; slot j of `from_ints_eval` refers to position j of that
order (self-consistent packing convention used by slot gates).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops.elementwise import ew_add, ew_mul, ew_mul_mont_const, ew_neg, ew_sub, reduce_once
from .element import FinRingElem
from .ntt import ntt_fwd, ntt_inv
from .params import RingParams

COEFF = "coeff"
EVAL = "eval"

_MAGIC = b"MXTP"


def residues_from_int(params: RingParams, value: int) -> np.ndarray:
    """Per-limb residues [L] of a (possibly big) integer."""
    return np.array([value % q for q in params.moduli], dtype=np.uint32)


def residue_planes_from_ints(params: RingParams, values) -> np.ndarray:
    """[L, len(values)] residue planes from a list of Python ints."""
    out = np.empty((params.crt_depth, len(values)), dtype=np.uint32)
    vals = [int(v) for v in values]
    if all(0 <= v < (1 << 63) for v in vals):
        arr = np.array(vals, dtype=np.uint64)
        for t, q in enumerate(params.moduli):
            out[t] = (arr % np.uint64(q)).astype(np.uint32)
    else:
        for t, q in enumerate(params.moduli):
            out[t] = np.array([v % q for v in vals], dtype=np.uint32)
    return out


@dataclass(frozen=True)
class Poly:
    """An element of R_q = Z_q[x]/(x^n + 1) in DCRT (RNS) representation."""

    data: jnp.ndarray  # uint32[L, n]
    fmt: str
    params: RingParams

    # ------------------------------------------------------------ construct

    @staticmethod
    def zero(params: RingParams, fmt: str = EVAL) -> "Poly":
        return Poly(jnp.zeros((params.crt_depth, params.n), dtype=jnp.uint32), fmt, params)

    @staticmethod
    def const(params: RingParams, value: int) -> "Poly":
        """Constant polynomial (value in every EVAL slot)."""
        res = residues_from_int(params, value)
        data = jnp.broadcast_to(jnp.asarray(res)[:, None], (params.crt_depth, params.n))
        return Poly(data, EVAL, params)

    @staticmethod
    def one(params: RingParams) -> "Poly":
        return Poly.const(params, 1)

    @staticmethod
    def minus_one(params: RingParams) -> "Poly":
        return Poly.const(params, -1)

    @staticmethod
    def from_int_coeffs(params: RingParams, coeffs) -> "Poly":
        """Coefficient-order construction from ints (arbitrary precision)."""
        assert len(coeffs) == params.n, (len(coeffs), params.n)
        planes = residue_planes_from_ints(params, coeffs)
        return Poly(jnp.asarray(planes), COEFF, params)

    @staticmethod
    def from_elems(params: RingParams, elems: list[FinRingElem]) -> "Poly":
        return Poly.from_int_coeffs(params, [e.value for e in elems])

    @staticmethod
    def from_elem_to_constant(params: RingParams, elem: FinRingElem) -> "Poly":
        return Poly.const(params, elem.value)

    @staticmethod
    def from_power_of_base_to_constant(params: RingParams, i: int) -> "Poly":
        return Poly.const(params, 1 << (params.base_bits * i))

    @staticmethod
    def from_ints_eval(params: RingParams, values) -> "Poly":
        """Place integer values into EVAL slots (reference from_biguints_eval,
        poly/mod.rs:from_biguints_eval)."""
        assert len(values) == params.n
        planes = residue_planes_from_ints(params, values)
        return Poly(jnp.asarray(planes), EVAL, params)

    @staticmethod
    def from_decomposed(params: RingParams, digit_polys: list["Poly"]) -> "Poly":
        """Recompose sum_i digits[i] * base^i (reference poly.rs:161-176)."""
        acc = Poly.zero(params)
        for i, dp in enumerate(digit_polys):
            scale = residues_from_int(params, 1 << (params.base_bits * i))
            scale_mont = (scale.astype(np.uint64) << 32) % params.np_moduli.astype(np.uint64)
            term = ew_mul_mont_const(
                dp.to_eval().data,
                jnp.asarray(scale_mont.astype(np.uint32)),
                params.jt.moduli,
                params.jt.qinv_neg,
            )
            acc = Poly(ew_add(acc.data, term, params.jt.moduli), EVAL, params)
        return acc

    # --------------------------------------------------------------- format

    def to_eval(self) -> "Poly":
        if self.fmt == EVAL:
            return self
        jt = self.params.jt
        return Poly(ntt_fwd(self.data, jt.psi_rev_mont, jt.moduli, jt.qinv_neg), EVAL, self.params)

    def to_coeff(self) -> "Poly":
        if self.fmt == COEFF:
            return self
        jt = self.params.jt
        data = ntt_inv(self.data, jt.psi_inv_rev_mont, jt.n_inv_mont, jt.moduli, jt.qinv_neg)
        return Poly(data, COEFF, self.params)

    # ------------------------------------------------------------ accessors

    def coeffs(self) -> list[int]:
        """Big-int coefficients in [0, q) (host CRT reconstruction)."""
        arr = np.asarray(self.to_coeff().data)
        p = self.params
        return [p.reconstruct_coeff(arr[:, j]) for j in range(p.n)]

    def coeffs_np(self) -> np.ndarray:
        """Per-limb coefficient residues as numpy [L, n]."""
        return np.asarray(self.to_coeff().data)

    def const_coeff(self) -> int:
        arr = np.asarray(self.to_coeff().data[:, 0])
        return self.params.reconstruct_coeff(arr)

    def const_value(self) -> int:
        """Value of a CONSTANT polynomial WITHOUT an NTT: a constant has its
        value in every EVAL slot and in COEFF coefficient 0, so either format
        reads column 0 directly. Callers must know the poly is constant
        (LUT inputs are, by construction) — per-gate const_coeff() cost one
        device iNTT + sync each, which dominated LUT-heavy circuit eval."""
        d = self.data
        col = d[:, 0] if isinstance(d, np.ndarray) else np.asarray(d)[:, 0]
        return self.params.reconstruct_coeff(np.asarray(col))

    def const_coeff_u64(self) -> int:
        return self.const_coeff()

    def eval_slots(self) -> list[int]:
        arr = np.asarray(self.to_eval().data)
        p = self.params
        return [p.reconstruct_coeff(arr[:, j]) for j in range(p.n)]

    # ----------------------------------------------------------- arithmetic

    def _harmonized(self, other: "Poly") -> tuple["Poly", "Poly", str]:
        assert self.params is other.params, "params mismatch"
        if self.fmt == other.fmt:
            return self, other, self.fmt
        return self.to_eval(), other.to_eval(), EVAL

    def __add__(self, other: "Poly") -> "Poly":
        a, b, fmt = self._harmonized(other)
        return Poly(ew_add(a.data, b.data, self.params.jt.moduli), fmt, self.params)

    def __sub__(self, other: "Poly") -> "Poly":
        a, b, fmt = self._harmonized(other)
        return Poly(ew_sub(a.data, b.data, self.params.jt.moduli), fmt, self.params)

    def __neg__(self) -> "Poly":
        return Poly(ew_neg(self.data, self.params.jt.moduli), self.fmt, self.params)

    def __mul__(self, other: "Poly") -> "Poly":
        a = self.to_eval()
        b = other.to_eval()
        jt = self.params.jt
        return Poly(ew_mul(a.data, b.data, jt.moduli, jt.qinv_neg, jt.r2), EVAL, self.params)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Poly) or self.params is not other.params:
            return NotImplemented
        a, b, _ = self._harmonized(other)
        return bool(jnp.array_equal(a.data, b.data))

    def __hash__(self):
        return id(self)

    # ------------------------------------------- Evaluable surface (circuits)

    def small_scalar_mul(self, params: RingParams, scalar: list[int]) -> "Poly":
        coeffs = list(scalar) + [0] * (params.n - len(scalar))
        return self * Poly.from_int_coeffs(params, coeffs)

    def large_scalar_mul(self, params: RingParams, scalar: list[int]) -> "Poly":
        coeffs = list(scalar) + [0] * (params.n - len(scalar))
        return self * Poly.from_int_coeffs(params, coeffs)

    # --------------------------------------------------- digit decomposition

    def decompose_base(self) -> list["Poly"]:
        """Positional base-2^b digits of the full big-int coefficients
        (reference poly.rs:246-286 `decompose_base`). Host path (rare op)."""
        p = self.params
        coeffs = self.coeffs()
        base_mask = (1 << p.base_bits) - 1
        out = []
        for d in range(p.modulus_digits):
            shift = d * p.base_bits
            out.append(Poly.from_int_coeffs(p, [(c >> shift) & base_mask for c in coeffs]))
        return out

    def extract_bits_with_threshold(self) -> list[bool]:
        """1 bit per coefficient: whether coeff falls in [q/4, 3q/4) —
        decodes a half-q-scaled message bit (reference poly.rs:329-340)."""
        q = self.params.modulus
        quarter = ((q + 1) // 2) >> 1
        three_quarter = quarter * 3
        return [quarter <= c < three_quarter for c in self.coeffs()]

    def to_bool_vec(self) -> list[bool]:
        return [c == 1 for c in self.coeffs()]

    # ---------------------------------------------------------------- serde

    def to_compact_bytes(self) -> bytes:
        p = self.params
        arr = np.asarray(self.data)
        header = _MAGIC + struct.pack(
            "<BBIIHB",
            1,
            0 if self.fmt == COEFF else 1,
            p.n,
            p.crt_depth,
            p.crt_bits,
            p.base_bits,
        )
        return header + arr.tobytes()

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes) -> "Poly":
        assert raw[:4] == _MAGIC
        ver, fmt_i, n, depth, crt_bits, base_bits = struct.unpack("<BBIIHB", raw[4:17])
        assert ver == 1 and n == params.n and depth == params.crt_depth
        arr = np.frombuffer(raw[17:], dtype=np.uint32).reshape(depth, n)
        return Poly(jnp.asarray(arr), COEFF if fmt_i == 0 else EVAL, params)

    def write_to_file(self, dir_path, poly_id: str):
        import os

        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, f"{poly_id}.mxxp"), "wb") as f:
            f.write(self.to_compact_bytes())

    @staticmethod
    def read_from_file(params: RingParams, dir_path, poly_id: str) -> "Poly":
        import os

        with open(os.path.join(dir_path, f"{poly_id}.mxxp"), "rb") as f:
            return Poly.from_compact_bytes(params, f.read())
