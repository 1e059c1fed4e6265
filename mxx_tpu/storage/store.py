"""Artifact store: batch lookup buffers + async background writer + JSON index.

Build of the reference storage subsystem
(/root/reference/src/storage/{write.rs,read.rs}): a global writer (here a
background thread pool instead of tokio), `BatchLookupBuffer`s holding
(index -> bytes) payloads under an id prefix, a `lookup_tables.index` JSON
global index, a `wait_for_all_writes` completion barrier, and multi-batch
readers that slice stored files by id.

Batch file format (one file per buffer): b"MXBT" | u32 count |
count * (u64 idx, u64 offset, u64 length) | payload blobs.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

_MAGIC = b"MXBT"
_INDEX_NAME = "lookup_tables.index"

_lock = threading.Lock()
_system: "StorageSystem | None" = None


@dataclass
class BatchLookupBuffer:
    id_prefix: str
    payloads: list[tuple[int, bytes]] = field(default_factory=list)

    def serialize(self) -> bytes:
        header = _MAGIC + struct.pack("<I", len(self.payloads))
        table = b""
        blobs = b""
        offset = 0
        for idx, raw in self.payloads:
            table += struct.pack("<QQQ", idx, offset, len(raw))
            blobs += raw
            offset += len(raw)
        return header + table + blobs


class StorageSystem:
    def __init__(self, dir_path: Path, workers: int = 4):
        self.dir_path = Path(dir_path)
        self.dir_path.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="mxx-storage")
        self._futures: list[Future] = []
        self._index_lock = threading.Lock()
        self._index: dict[str, dict] = {}
        self._load_index()

    def _index_path(self) -> Path:
        return self.dir_path / _INDEX_NAME

    def _load_index(self):
        p = self._index_path()
        if p.exists():
            try:
                self._index = json.loads(p.read_text()).get("entries", {})
            except (json.JSONDecodeError, OSError):
                self._index = {}

    def _write_index_atomic(self, entries: dict):
        tmp = self._index_path().with_suffix(".index.tmp")
        tmp.write_text(json.dumps({"entries": entries}))
        os.replace(tmp, self._index_path())

    def _flush_index(self):
        with self._index_lock:
            self._write_index_atomic(self._index)

    def _flush_index_durable(self, snapshot: dict, pending: list):
        """Background periodic flush: barrier on all writes submitted before
        the snapshot, THEN persist it — the on-disk index never references an
        artifact whose batch file is missing or partial (ADVICE r1 medium)."""
        from ..native.writer import wait_all_writes

        for f in pending:
            try:
                f.result()
            except Exception:
                return  # leave the index un-advanced; wait_for_all_writes reports
        wait_all_writes()
        with self._index_lock:
            self._write_index_atomic(snapshot)

    def _batch_file(self, prefix: str, part: int) -> Path:
        return self.dir_path / f"{prefix}_batch{part}.bin"

    def add_buffer(self, buffer: BatchLookupBuffer):
        """Enqueue a buffer; buffers over the size limit are split into
        multiple parts (reference write.rs BatchLookupBuffer auto-split by
        LUT_BYTES_LIMIT, :48-110)."""
        from .. import config

        limit = config.lut_bytes_limit()
        total = sum(len(raw) for _, raw in buffer.payloads)
        if total > limit and len(buffer.payloads) > 1:
            chunk: list = []
            size = 0
            for item in buffer.payloads:
                if chunk and size + len(item[1]) > limit:
                    self._add_one(BatchLookupBuffer(buffer.id_prefix, chunk))
                    chunk, size = [], 0
                chunk.append(item)
                size += len(item[1])
            if chunk:
                self._add_one(BatchLookupBuffer(buffer.id_prefix, chunk))
            return
        self._add_one(buffer)

    def _add_one(self, buffer: BatchLookupBuffer):
        from .. import config

        with self._index_lock:
            entry = self._index.setdefault(buffer.id_prefix, {"parts": 0, "indices": []})
            part = entry["parts"]
            entry["parts"] += 1
            entry["indices"] = sorted(set(entry["indices"]) | {i for i, _ in buffer.payloads})
            self._writes_since_sync = getattr(self, "_writes_since_sync", 0) + 1
            sync_due = self._writes_since_sync >= config.lut_index_sync_every()
            if sync_due:
                self._writes_since_sync = 0
        path = self._batch_file(buffer.id_prefix, part)

        from ..native.writer import submit_write, writer_available

        if writer_available():
            # native async writer (C++ worker pool; reference write.rs:363)
            submit_write(path, buffer.serialize())
        else:
            def write():
                tmp = path.with_suffix(path.suffix + ".tmp")
                tmp.write_bytes(buffer.serialize())
                os.replace(tmp, path)

            self._futures.append(self._pool.submit(write))
        if sync_due:
            # Periodic index flush so long offline passes are resumable even
            # without a final wait_for_all_writes (reference
            # LUT_INDEX_SYNC_EVERY). The flush happens in the background AFTER
            # a write barrier on everything submitted so far, so the persisted
            # index only ever names completed batch files.
            with self._index_lock:
                snapshot = json.loads(json.dumps(self._index))
            pending = list(self._futures)
            self._futures.append(
                self._pool.submit(self._flush_index_durable, snapshot, pending)
            )

    def wait_for_all_writes(self):
        for f in list(self._futures):
            f.result()
        self._futures.clear()
        from ..native.writer import wait_all_writes, write_errors

        wait_all_writes()
        assert write_errors() == 0, "native artifact writer reported I/O errors"
        self._flush_index()

    def read_bytes(self, prefix: str, idx: int) -> bytes | None:
        entry = self._index.get(prefix)
        parts = entry["parts"] if entry else self._count_parts(prefix)
        for part in range(parts):
            path = self._batch_file(prefix, part)
            if not path.exists():
                continue
            raw = path.read_bytes()
            assert raw[:4] == _MAGIC, f"bad batch magic in {path}"
            (count,) = struct.unpack("<I", raw[4:8])
            table_end = 8 + 24 * count
            for e in range(count):
                i, off, ln = struct.unpack("<QQQ", raw[8 + 24 * e : 8 + 24 * (e + 1)])
                if i == idx:
                    payload = raw[table_end + off : table_end + off + ln]
                    if len(payload) != ln:
                        raise IOError(
                            f"truncated batch file {path}: entry {idx} wants "
                            f"{ln} bytes at offset {off}, file has "
                            f"{len(raw) - table_end - off}"
                        )
                    return payload
        return None

    def _count_parts(self, prefix: str) -> int:
        part = 0
        while self._batch_file(prefix, part).exists():
            part += 1
        return part

    def has_index(self, prefix: str, idx: int) -> bool:
        entry = self._index.get(prefix)
        return entry is not None and idx in entry["indices"]


# ------------------------------------------------------------------ module API


def init_storage_system(dir_path) -> StorageSystem:
    global _system
    with _lock:
        _system = StorageSystem(Path(dir_path))
        return _system


def get_storage_system() -> StorageSystem:
    assert _system is not None, "call init_storage_system(dir) first"
    return _system


def get_lookup_buffer(matrices: list, id_prefix: str) -> BatchLookupBuffer:
    """Build a buffer from (idx, PolyMatrix) pairs.

    Device-to-host copies are issued asynchronously for the WHOLE batch
    before any serialization, so the per-matrix fetches overlap."""
    for _, m in matrices:
        try:
            m.data.copy_to_host_async()
        except AttributeError:
            break  # non-jax backing (e.g. already numpy) — nothing to overlap
    return BatchLookupBuffer(
        id_prefix, [(idx, m.to_compact_bytes()) for idx, m in matrices]
    )


def get_lookup_buffer_bytes(payloads: list[tuple[int, bytes]], id_prefix: str) -> BatchLookupBuffer:
    return BatchLookupBuffer(id_prefix, list(payloads))


def add_lookup_buffer(buffer: BatchLookupBuffer):
    get_storage_system().add_buffer(buffer)


def wait_for_all_writes(dir_path=None):
    get_storage_system().wait_for_all_writes()


def read_bytes_from_multi_batch(dir_path, id_prefix: str, idx: int) -> bytes | None:
    sys_ = _system
    if sys_ is None or Path(dir_path) != sys_.dir_path:
        sys_ = StorageSystem(Path(dir_path))
    return sys_.read_bytes(id_prefix, idx)


def read_matrix_from_multi_batch(params, dir_path, id_prefix: str, idx: int):
    from ..matrix import PolyMatrix

    raw = read_bytes_from_multi_batch(dir_path, id_prefix, idx)
    if raw is None:
        return None
    return PolyMatrix.from_compact_bytes(params, raw)
