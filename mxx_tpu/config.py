"""Env-var configuration (reference /root/reference/src/env.rs:31-185).

Same variable names as the reference where the concept carries over, so
existing deployment recipes translate directly.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def circuit_parallel_gates(override: int | None = None) -> int:
    if override is not None:
        return override
    return _env_int("MXX_CIRCUIT_PARALLEL_GATES", 8)


def lut_preimage_chunk_size() -> int:
    return _env_int("LUT_PREIMAGE_CHUNK_SIZE", 16)


def aux_sampling_chunk_width() -> int:
    return _env_int("AUX_SAMPLING_CHUNK_WIDTH", 1 << 12)


def mul_decompose_column_chunk_width() -> int:
    return _env_int("MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH", 0)  # 0 = no chunking


def noise_refresh_decoder_chunk_size() -> int:
    return _env_int("MXX_NOISE_REFRESH_DECODER_CHUNK_SIZE", 8)


def block_size() -> int:
    return _env_int("BLOCK_SIZE", 64)


def lut_bytes_limit() -> int:
    return _env_int("LUT_BYTES_LIMIT", 1 << 30)


def circuit_live_bytes_budget() -> int:
    """Device-resident wire budget for the batched circuit evaluator; idle
    wires beyond it spill to host compact bytes (reference eval.rs compact-
    form wire caching). 0 = unbounded."""
    return _env_int("MXX_CIRCUIT_LIVE_BYTES_BUDGET", 0)


def offload_budget_bytes() -> int:
    """Device-resident budget for accumulated offline plane operands (LWE
    K_high preimage targets and similar): beyond it, assembled targets spill
    to host/disk memmaps (matrix/offload.py) and rehydrate chunk-by-chunk
    inside the batched preimage pass — the reference's disk-backed matrix
    backend made drop-in (matrix/base/disk.rs:18-40). 0 = unbounded."""
    return _env_int("MXX_OFFLOAD_BUDGET_BYTES", 0)


def diamond_io_eval_relation_asserts() -> bool:
    return os.environ.get("MXX_DIAMOND_IO_EVAL_RELATION_ASSERTS", "") == "1"


def bgg_poly_encoding_slot_parallelism() -> int:
    """Slots evaluated concurrently for packed encodings (reference env.rs
    BGG_POLY_ENCODING_SLOT_PARALLELISM; informational here — packed slot ops
    are single batched matmuls here)."""
    return _env_int("BGG_POLY_ENCODING_SLOT_PARALLELISM", 8)


def slot_transfer_slot_parallelism() -> int:
    """Slots preprocessed concurrently in slot-transfer aux sampling
    (reference env.rs SLOT_TRANSFER_SLOT_PARALLELISM)."""
    return _env_int("SLOT_TRANSFER_SLOT_PARALLELISM", 8)


def lut_index_sync_every() -> int:
    """Flush the storage JSON index every N buffer writes (reference env.rs
    LUT_INDEX_SYNC_EVERY)."""
    return _env_int("LUT_INDEX_SYNC_EVERY", 64)
