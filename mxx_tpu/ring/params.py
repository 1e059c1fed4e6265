"""DCRT (RNS) ring parameters for the lattice framework.

`RingParams` is the analog of the reference's `DCRTPolyParams`
(/root/reference/src/poly/dcrt/params.rs:10-110). It generates its own CRT
basis (primes q_t = 1 mod 2n, each `crt_bits` bits) instead of delegating to
OpenFHE FFI, and precomputes every device table needed by the kernels:

- Montgomery constants per limb (R = 2^32).
- Negacyclic NTT twiddle tables in bit-reversed order (Longa-Naehrig layout),
  stored in Montgomery form.
- CRT idempotent residues and gadget-vector residues for the per-tower
  base-2^b digit decomposition (G / G^{-1}), including `decompose_last_mask`
  semantics (params.rs:82-96).
- Balanced int8-digit combination constants for the exact matmul path.

A polynomial is an array uint32[L, n]; a polynomial matrix uint32[L, r, c, n].
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np

from ..utils import numth

R32 = 1 << 32


@functools.lru_cache(maxsize=None)
def _params_cache(ring_dimension, crt_depth, crt_bits, base_bits):
    return RingParams(
        ring_dimension=ring_dimension,
        crt_depth=crt_depth,
        crt_bits=crt_bits,
        base_bits=base_bits,
    )


@dataclass(frozen=True, eq=False)
class RingParams:
    """Static ring parameters + cached host/device tables.

    Instances are interned by `RingParams.new(...)`; identity equality is
    intentional so jit caches key on the object.
    """

    ring_dimension: int
    crt_depth: int
    crt_bits: int
    base_bits: int
    _tables: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def new(ring_dimension: int, crt_depth: int, crt_bits: int, base_bits: int) -> "RingParams":
        assert ring_dimension >= 2 and (ring_dimension & (ring_dimension - 1)) == 0, (
            "ring_dimension must be a power of 2"
        )
        assert 1 <= base_bits <= crt_bits
        return _params_cache(ring_dimension, crt_depth, crt_bits, base_bits)

    @staticmethod
    def default() -> "RingParams":
        """Insecure test parameters (reference params.rs:71-74)."""
        return RingParams.new(4, 2, 17, 1)

    # ---------------------------------------------------------------- basics

    @property
    def n(self) -> int:
        return self.ring_dimension

    @property
    def log_n(self) -> int:
        return self.ring_dimension.bit_length() - 1

    @functools.cached_property
    def moduli(self) -> tuple[int, ...]:
        return numth.gen_crt_moduli(self.ring_dimension, self.crt_depth, self.crt_bits)

    @functools.cached_property
    def modulus(self) -> int:
        """The full composite modulus q = prod q_t (host big int)."""
        return math.prod(self.moduli)

    @property
    def modulus_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def digits_per_tower(self) -> int:
        return -(-self.crt_bits // self.base_bits)

    @property
    def modulus_digits(self) -> int:
        """k: total gadget digits = digits_per_tower * crt_depth."""
        return self.digits_per_tower * self.crt_depth

    @property
    def base(self) -> int:
        return 1 << self.base_bits

    @property
    def decompose_last_mask(self) -> int | None:
        """Mask for the most-significant digit within each CRT tower."""
        if self.crt_bits % self.base_bits == 0:
            return None
        last_bits = self.crt_bits - self.base_bits * (self.digits_per_tower - 1)
        return (1 << last_bits) - 1

    def to_crt(self) -> tuple[tuple[int, ...], int, int]:
        return (self.moduli, self.crt_bits, self.crt_depth)

    # ----------------------------------------------------- host CRT helpers

    @functools.cached_property
    def crt_idempotents(self) -> tuple[int, ...]:
        """e_t = (q/q_t) * ((q/q_t)^{-1} mod q_t) mod q: e_t = 1 mod q_t, 0 mod q_s."""
        q = self.modulus
        out = []
        for qt in self.moduli:
            qh = q // qt
            out.append(qh * numth.modinv(qh % qt, qt) % q)
        return tuple(out)

    def reconstruct_coeff(self, residues) -> int:
        """CRT-reconstruct one coefficient from its per-limb residues."""
        acc = 0
        for r, e in zip(residues, self.crt_idempotents):
            acc += int(r) * e
        return acc % self.modulus

    # --------------------------------------------------------- numpy tables
    # All tables are numpy on first access (cheap to pickle / hash-free); the
    # jnp versions live behind `.jt` (JaxTables) below.

    def _table(self, name, builder):
        if name not in self._tables:
            self._tables[name] = builder()
        return self._tables[name]

    @property
    def np_moduli(self) -> np.ndarray:
        return self._table("np_moduli", lambda: np.array(self.moduli, dtype=np.uint32))

    @property
    def np_qinv_neg(self) -> np.ndarray:
        def build():
            return np.array(
                [(-numth.modinv(q, R32)) % R32 for q in self.moduli], dtype=np.uint32
            )

        return self._table("np_qinv_neg", build)

    @property
    def np_r1(self) -> np.ndarray:
        """R mod q (Montgomery form of 1)."""
        return self._table(
            "np_r1", lambda: np.array([R32 % q for q in self.moduli], dtype=np.uint32)
        )

    @property
    def np_r2(self) -> np.ndarray:
        """R^2 mod q."""
        return self._table(
            "np_r2", lambda: np.array([R32 * R32 % q for q in self.moduli], dtype=np.uint32)
        )

    def _psi_tables(self):
        def build():
            n, ln = self.n, self.log_n
            psi_rev = np.empty((self.crt_depth, n), dtype=np.uint32)
            psi_inv_rev = np.empty((self.crt_depth, n), dtype=np.uint32)
            n_inv = np.empty((self.crt_depth,), dtype=np.uint32)
            for t, q in enumerate(self.moduli):
                psi = numth.find_primitive_2n_root(q, n)
                psi_i = numth.modinv(psi, q)
                for i in range(n):
                    b = numth.bit_reverse(i, ln)
                    psi_rev[t, i] = pow(psi, b, q) * R32 % q
                    psi_inv_rev[t, i] = pow(psi_i, b, q) * R32 % q
                n_inv[t] = numth.modinv(n, q) * R32 % q
            return psi_rev, psi_inv_rev, n_inv

        return self._table("psi", build)

    @property
    def np_psi_rev_mont(self) -> np.ndarray:
        return self._psi_tables()[0]

    @property
    def np_psi_inv_rev_mont(self) -> np.ndarray:
        return self._psi_tables()[1]

    @property
    def np_n_inv_mont(self) -> np.ndarray:
        return self._psi_tables()[2]

    @property
    def np_gadget_res(self) -> np.ndarray:
        """Gadget vector residues [k, L]: gv[t*dpt+j, s] = b^j * e_t mod q_s.

        Matches the per-tower gadget convention of the reference's
        `DCRTPolyGadgetVector` usage (matrix/dcrt_poly.rs:441-455): digit
        (tower t, position j) has weight b^j on tower t and 0 elsewhere.
        """

        def build():
            dpt = self.digits_per_tower
            k = self.modulus_digits
            out = np.empty((k, self.crt_depth), dtype=np.uint32)
            for t in range(self.crt_depth):
                et = self.crt_idempotents[t]
                for j in range(dpt):
                    v = (1 << (self.base_bits * j)) * et % self.modulus
                    for s, qs in enumerate(self.moduli):
                        out[t * dpt + j, s] = v % qs
            return out

        return self._table("np_gadget_res", build)

    @property
    def np_small_gadget_res(self) -> np.ndarray:
        """Small gadget residues [dpt, L]: b^j mod q_s (constant poly b^j)."""

        def build():
            dpt = self.digits_per_tower
            out = np.empty((dpt, self.crt_depth), dtype=np.uint32)
            for j in range(dpt):
                v = 1 << (self.base_bits * j)
                for s, qs in enumerate(self.moduli):
                    out[j, s] = v % qs
            return out

        return self._table("np_small_gadget_res", build)

    @property
    def np_digit_masks(self) -> np.ndarray:
        """Per-digit-position masks [dpt] for in-tower decomposition."""

        def build():
            dpt = self.digits_per_tower
            masks = np.full((dpt,), (1 << self.base_bits) - 1, dtype=np.uint32)
            if self.decompose_last_mask is not None:
                masks[dpt - 1] = self.decompose_last_mask
            return masks

        return self._table("np_digit_masks", build)

    # int8-digit matmul combination constants: 2^{8s} mod q (Montgomery form)
    # and the sign-correction constants 2^{32+8s} mod q (standard form).
    @property
    def np_combine_pows_mont(self) -> np.ndarray:
        def build():
            out = np.empty((7, self.crt_depth), dtype=np.uint32)
            for s in range(7):
                for t, q in enumerate(self.moduli):
                    out[s, t] = (1 << (8 * s)) * R32 % q
            return out

        return self._table("np_combine_pows_mont", build)

    @property
    def np_sign_corr_pows(self) -> np.ndarray:
        def build():
            out = np.empty((7, self.crt_depth), dtype=np.uint32)
            for s in range(7):
                for t, q in enumerate(self.moduli):
                    out[s, t] = (1 << (32 + 8 * s)) % q
            return out

        return self._table("np_sign_corr_pows", build)

    @functools.cached_property
    def jt(self) -> "JaxTables":
        return JaxTables(self)

    def __hash__(self):
        return hash((self.ring_dimension, self.crt_depth, self.crt_bits, self.base_bits))

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return (
            f"RingParams(n={self.ring_dimension}, depth={self.crt_depth}, "
            f"crt_bits={self.crt_bits}, base_bits={self.base_bits})"
        )


class JaxTables:
    """jnp device views of the params tables (lazily created, cached)."""

    def __init__(self, params: RingParams):
        self._p = params
        self._cache: dict = {}

    def _get(self, name):
        if name not in self._cache:
            import jax
            import jax.numpy as jnp

            np_val = getattr(self._p, "np_" + name)
            # force a concrete device array even if first touched inside a
            # jit trace — otherwise the cache would capture a Tracer and
            # poison every later use (UnexpectedTracerError)
            with jax.ensure_compile_time_eval():
                self._cache[name] = jnp.asarray(np_val)
        return self._cache[name]

    @property
    def moduli(self):
        return self._get("moduli")

    @property
    def qinv_neg(self):
        return self._get("qinv_neg")

    @property
    def r1(self):
        return self._get("r1")

    @property
    def r2(self):
        return self._get("r2")

    @property
    def psi_rev_mont(self):
        return self._get("psi_rev_mont")

    @property
    def psi_inv_rev_mont(self):
        return self._get("psi_inv_rev_mont")

    @property
    def n_inv_mont(self):
        return self._get("n_inv_mont")

    @property
    def gadget_res(self):
        return self._get("gadget_res")

    @property
    def small_gadget_res(self):
        return self._get("small_gadget_res")

    @property
    def digit_masks(self):
        return self._get("digit_masks")

    @property
    def combine_pows_mont(self):
        return self._get("combine_pows_mont")

    @property
    def sign_corr_pows(self):
        return self._get("sign_corr_pows")

    # ------------------------------------------- modulus-switch tables (per P)

    def _ms_tables(self, new_modulus: int):
        key = ("ms", new_modulus)
        if key not in self._cache:
            import jax
            import jax.numpy as jnp

            q = self._p.modulus
            ints = []
            fracs = []
            for e in self._p.crt_idempotents:
                num = e * new_modulus
                ints.append((num // q) % new_modulus)
                # exact rational remainder -> float64 fraction
                fracs.append(float((num % q) / q))
            with jax.ensure_compile_time_eval():
                self._cache[key] = (
                    jnp.asarray(np.array(ints, dtype=np.uint64)),
                    jnp.asarray(np.array(fracs, dtype=np.float64)),
                )
        return self._cache[key]

    def ms_int_parts(self, new_modulus: int):
        """floor(e_t * P / q) mod P per limb (uint64[L])."""
        return self._ms_tables(new_modulus)[0]

    def ms_frac_parts(self, new_modulus: int):
        """frac(e_t * P / q) per limb (float64[L])."""
        return self._ms_tables(new_modulus)[1]
