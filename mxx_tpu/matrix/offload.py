"""Out-of-core polynomial matrices: host/disk offload + streamed ops.

Build of the reference's src/matrix/base/disk.rs (mmap-file-backed
BaseMatrix) and the column-chunk pipelines of P5/P8 (SURVEY.md 2.7): large
artifacts live in a numpy memmap of the raw limb planes; compute streams
column chunks through the device, so peak device memory is one chunk instead
of the whole operand. The offload target is host RAM / disk via memmap
instead of the reference's mmap tempfiles.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ring.params import RingParams
from .poly_matrix import PolyMatrix


@dataclass
class OffloadedMatrix:
    """A PolyMatrix resident in a host memmap (disk-backed)."""

    path: str
    shape: tuple[int, int, int, int]  # [L, r, c, n]
    fmt: str
    params: RingParams
    _owns_file: bool = False

    @property
    def nrow(self) -> int:
        return self.shape[1]

    @property
    def ncol(self) -> int:
        return self.shape[2]

    def _mmap(self, mode="r") -> np.memmap:
        return np.memmap(self.path, dtype=np.uint32, mode=mode, shape=self.shape)

    def load(self) -> PolyMatrix:
        """Materialize the full matrix on device."""
        return PolyMatrix(jnp.asarray(np.asarray(self._mmap())), self.fmt, self.params)

    def load_columns(self, start: int, end: int) -> PolyMatrix:
        """Materialize a column window on device (column-chunk streaming)."""
        chunk = np.asarray(self._mmap()[:, :, start:end, :])
        return PolyMatrix(jnp.asarray(chunk), self.fmt, self.params)

    def load_rows(self, start: int, end: int) -> PolyMatrix:
        chunk = np.asarray(self._mmap()[:, start:end, :, :])
        return PolyMatrix(jnp.asarray(chunk), self.fmt, self.params)

    def delete(self):
        if self._owns_file and os.path.exists(self.path):
            os.unlink(self.path)


def offload_matrix(mat: PolyMatrix, path: str | None = None) -> OffloadedMatrix:
    """Move a device matrix into a host memmap; frees the device buffer once
    the caller drops its reference."""
    owns = path is None
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".mxmm")
        os.close(fd)
    data = np.asarray(mat.data)
    mm = np.memmap(path, dtype=np.uint32, mode="w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    return OffloadedMatrix(path, tuple(data.shape), mat.fmt, mat.params, owns)


def matmul_streamed(a: PolyMatrix, b: OffloadedMatrix, chunk_cols: int = 64) -> PolyMatrix:
    """a @ B for an offloaded B, streaming column chunks through the device
    (reference mul_decompose column loop, matrix/dcrt_poly.rs:248-274; P5)."""
    assert a.ncol == b.nrow, (a.ncol, b.nrow)
    outs = []
    for start in range(0, b.ncol, chunk_cols):
        end = min(start + chunk_cols, b.ncol)
        outs.append(a @ b.load_columns(start, end))
    return outs[0].concat_columns(outs[1:])


def matmul_offloaded_lhs(a: OffloadedMatrix, b: PolyMatrix,
                         chunk_rows: int = 64) -> PolyMatrix:
    """A @ b for an offloaded A, streaming row chunks of A."""
    assert a.ncol == b.nrow, (a.ncol, b.nrow)
    outs = []
    for start in range(0, a.nrow, chunk_rows):
        end = min(start + chunk_rows, a.nrow)
        outs.append(a.load_rows(start, end) @ b)
    return outs[0].concat_rows(outs[1:])
