"""Options for the port, trimmed to the fields this slice reads.

Field names, environment variables and defaults follow
`parseable_tpu/config.py`, except `query_engine`, whose default is "gpu":
entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path


def _env(name: str, default: str | None = None) -> str | None:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    v = _env(name)
    return int(v) if v is not None else default


class Compression(str, Enum):
    """Parquet compression (default lz4_raw, as in the JAX package)."""

    UNCOMPRESSED = "uncompressed"
    SNAPPY = "snappy"
    GZIP = "gzip"
    BROTLI = "brotli"
    LZ4 = "lz4"
    LZ4_RAW = "lz4_raw"
    ZSTD = "zstd"

    def to_parquet(self) -> str:
        """Map to a pyarrow parquet codec name."""
        return "none" if self is Compression.UNCOMPRESSED else self.value


@dataclass
class Options:
    """Server options read by the query slice."""

    local_staging_path: Path = field(
        default_factory=lambda: Path(_env("P_STAGING_DIR", "./staging"))
    )
    row_group_size: int = field(
        default_factory=lambda: _env_int("P_PARQUET_ROW_GROUP_SIZE", 262_144)
    )
    parquet_compression: Compression = field(
        default_factory=lambda: Compression(_env("P_PARQUET_COMPRESSION_ALGO", "lz4_raw"))
    )
    query_timeout_secs: int = field(default_factory=lambda: _env_int("P_QUERY_TIMEOUT", 300))
    query_memory_limit_bytes: int | None = field(
        default_factory=lambda: (
            int(v) if (v := _env("P_QUERY_MEMORY_LIMIT")) is not None else None
        )
    )
    # "gpu" runs aggregates through the CUDA group-by kernels; "cpu" is the
    # pyarrow engine (the oracle the GPU engine is held against)
    query_engine: str = field(default_factory=lambda: _env("P_QUERY_ENGINE", "gpu"))
    # scan tables coalesce into device blocks of at least this many rows
    device_block_rows: int = field(default_factory=lambda: _env_int("P_TPU_BLOCK_ROWS", 1 << 20))

    def staging_dir(self) -> Path:
        self.local_staging_path.mkdir(parents=True, exist_ok=True)
        return self.local_staging_path


@dataclass
class StorageOptions:
    """Storage backend; this slice supports `local-store` only."""

    backend: str = "local-store"
    root: Path = field(default_factory=lambda: Path(_env("P_FS_DIR", "./data")))


def generate_node_id() -> str:
    return uuid.uuid4().hex
