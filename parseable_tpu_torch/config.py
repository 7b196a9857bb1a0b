"""Options / CLI configuration for the port.

Counterpart of `parseable_tpu/config.py`, trimmed to the fields the port
reads. Field names, environment variables and defaults follow the JAX
package, except `query_engine`, whose default is "gpu": entry points run on
the card unless the caller asks for the CPU. A node runs in one of the JAX
package's modes (`P_MODE`): `all` ingests and answers queries, `ingest`
ingests and serves its slice to queriers, `query` answers queries over
every live ingestor (`server/cluster.py`, `query/fanout.py`).
"""

from __future__ import annotations

import argparse
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


def _env_bool(name: str, default: bool) -> bool:
    v = _env(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


# Accessors for the budgets and the switches that the hot set, the
# encoded-block cache and the GPU executor read at call time rather than
# through `Options` (P_TPU_HOT_BYTES, P_TPU_ENC_CACHE_BYTES, P_TPU_ENC_CACHE,
# P_TPU_ADAPTIVE).
def env_str(name: str, default: str | None = None) -> str | None:
    return _env(name, default)


def env_int(name: str, default: int) -> int:
    return _env_int(name, default)


class Mode(str, Enum):
    """Server modes (reference: src/option.rs Mode enum, main.rs:54-70)."""

    ALL = "all"
    INGEST = "ingest"
    QUERY = "query"

    def to_str(self) -> str:
        return {Mode.ALL: "All", Mode.INGEST: "Ingest", Mode.QUERY: "Query"}[self]


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
    """Server options."""

    # --- server ---------------------------------------------------------------
    address: str = field(default_factory=lambda: _env("P_ADDR", "0.0.0.0:8000"))
    # advertised endpoints: behind NAT or a load balancer the bind address
    # is not what peers dial (`Parseable.register_node`)
    ingestor_endpoint: str = field(default_factory=lambda: _env("P_INGESTOR_ENDPOINT", ""))
    querier_endpoint: str = field(default_factory=lambda: _env("P_QUERIER_ENDPOINT", ""))
    # Arrow Flight data plane (`server/flight.py`): an ingest-capable node
    # serves the staging fan-in and the partial pushdown on this port when
    # > 0; HTTP + Arrow IPC on the main port stays the fallback tier
    flight_port: int = field(default_factory=lambda: _env_int("P_FLIGHT_PORT", 0))
    # client side: 0 pins intra-cluster fetches to HTTP even where peers
    # advertise Flight
    flight_client: bool = field(default_factory=lambda: _env_bool("P_FLIGHT_CLIENT", True))
    mode: Mode = field(default_factory=lambda: Mode(_env("P_MODE", "all").lower()))
    username: str = field(default_factory=lambda: _env("P_USERNAME", "admin"))
    password: str = field(default_factory=lambda: _env("P_PASSWORD", "admin"))

    # --- staging --------------------------------------------------------------
    local_staging_path: Path = field(
        default_factory=lambda: Path(_env("P_STAGING_DIR", "./staging"))
    )
    # rows buffered in the arrow writer before a disk write
    disk_write_batch_rows: int = field(
        default_factory=lambda: _env_int("P_DISK_WRITE_BATCH_ROWS", 10_000)
    )
    max_arrow_files_per_parquet: int = field(
        default_factory=lambda: _env_int("P_MAX_ARROW_FILES_PER_PARQUET", 20)
    )
    enable_memory_staging: bool = field(
        default_factory=lambda: _env_bool("P_ENABLE_MEMORY_STAGING", False)
    )

    # --- parquet --------------------------------------------------------------
    row_group_size: int = field(
        default_factory=lambda: _env_int("P_PARQUET_ROW_GROUP_SIZE", 262_144)
    )
    parquet_compression: Compression = field(
        default_factory=lambda: Compression(_env("P_PARQUET_COMPRESSION_ALGO", "lz4_raw"))
    )

    # --- query ----------------------------------------------------------------
    query_timeout_secs: int = field(default_factory=lambda: _env_int("P_QUERY_TIMEOUT", 300))
    query_memory_limit_bytes: int | None = field(
        default_factory=lambda: (
            int(v) if (v := _env("P_QUERY_MEMORY_LIMIT")) is not None else None
        )
    )
    # "gpu" runs aggregates through the CUDA group-by kernels; "cpu" is the
    # pyarrow engine (the oracle the GPU engine is held against)
    query_engine: str = field(default_factory=lambda: _env("P_QUERY_ENGINE", "gpu"))
    # threads answering HTTP queries
    query_workers: int = field(
        default_factory=lambda: _env_int("P_QUERY_WORKERS", min(8, os.cpu_count() or 1))
    )
    # scan tables coalesce into device blocks of at least this many rows
    device_block_rows: int = field(default_factory=lambda: _env_int("P_TPU_BLOCK_ROWS", 1 << 20))
    # the device mesh of the GPU engine (`executor_cuda.resolve_mesh`): ""
    # shards over every visible card when there are several, "off" never,
    # "data:N" / "N" over N cards, "NxM" a data x groups layout
    mesh_shape: str = field(default_factory=lambda: _env("P_TPU_MESH", ""))
    # byte budget of the partial-aggregate result cache keyed on (stream,
    # manifest-set fingerprint, plan fingerprint); 0 disables
    query_result_cache_bytes: int = field(
        default_factory=lambda: _env_int("P_QUERY_RESULT_CACHE_BYTES", 64 * 1024 * 1024)
    )

    # --- distributed query fan-out (query/fanout.py, server/cluster.py) -----
    # a query node scatters partializable GROUP BY aggregates to the live
    # ingestors (each answers one partial over its own slice) instead of
    # pulling their raw staging windows; 0 keeps every query central
    query_pushdown: bool = field(default_factory=lambda: _env_bool("P_QUERY_PUSHDOWN", True))
    # per-peer pushdown timeout; a timed-out peer gets ONE retry, then its
    # slice is served centrally
    fanout_timeout_ms: int = field(default_factory=lambda: _env_int("P_FANOUT_TIMEOUT_MS", 10_000))
    # a duplicate request goes to a peer whose first attempt is still
    # outstanding after this long (first answer wins); 0 disables hedging
    fanout_hedge_ms: int = field(default_factory=lambda: _env_int("P_FANOUT_HEDGE_MS", 1500))
    # pushdown requests in flight at once; further peers go out as earlier
    # ones resolve
    fanout_max_inflight: int = field(
        default_factory=lambda: _env_int("P_FANOUT_MAX_INFLIGHT", 8)
    )

    # --- ingest ---------------------------------------------------------------
    max_event_payload_bytes: int = field(
        default_factory=lambda: _env_int("P_MAX_EVENT_PAYLOAD_SIZE", 10 * 1024 * 1024)
    )
    event_flatten_level: int = field(default_factory=lambda: _env_int("P_MAX_FLATTEN_LEVEL", 10))
    # hours a time-partitioned event may lag the first one seen
    event_max_chunk_age: int = field(default_factory=lambda: _env_int("P_EVENT_MAX_CHUNK_AGE", 24))
    dataset_fields_allowed_limit: int = field(
        default_factory=lambda: _env_int("P_DATASET_FIELD_COUNT_LIMIT", 250)
    )

    # --- sync -----------------------------------------------------------------
    local_sync_interval_secs: int = field(
        default_factory=lambda: _env_int("P_LOCAL_SYNC_INTERVAL", 60)
    )
    upload_interval_secs: int = field(
        default_factory=lambda: _env_int("P_STORAGE_UPLOAD_INTERVAL", 30)
    )
    # workers on the sync pool: arrow-group -> parquet compaction jobs
    sync_workers: int = field(
        default_factory=lambda: _env_int("P_SYNC_WORKERS", min(8, os.cpu_count() or 1))
    )

    def get_scheme(self) -> str:
        """URL scheme peers dial this node with. The port serves plain HTTP
        (TLS is a later slice)."""
        return "http"

    def staging_dir(self) -> Path:
        self.local_staging_path.mkdir(parents=True, exist_ok=True)
        return self.local_staging_path


@dataclass
class StorageOptions:
    """Storage backend; the port supports `local-store` only."""

    backend: str = "local-store"
    root: Path = field(default_factory=lambda: Path(_env("P_FS_DIR", "./data")))


def generate_node_id() -> str:
    return uuid.uuid4().hex


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parseable-tpu-torch",
        description="observability data lake on PyTorch/CUDA (parseable-compatible API)",
    )
    sub = p.add_subparsers(dest="backend")
    sp = sub.add_parser("local-store")
    sp.add_argument("--fs-dir", default=None, help="root dir for local-store")
    p.add_argument("--address", default=None)
    p.add_argument("--mode", default=None, choices=[m.value for m in Mode])
    p.add_argument("--staging-dir", default=None)
    p.add_argument("--query-engine", default=None, choices=["gpu", "cpu"])
    return p


def parse_cli(argv: list[str] | None = None) -> tuple[Options, StorageOptions]:
    args = build_parser().parse_args(argv)
    opts = Options()
    if args.address:
        opts.address = args.address
    if args.mode:
        opts.mode = Mode(args.mode)
    if args.staging_dir:
        opts.local_staging_path = Path(args.staging_dir)
    if args.query_engine:
        opts.query_engine = args.query_engine
    storage = StorageOptions()
    if args.backend:
        storage.backend = args.backend
        if args.fs_dir:
            storage.root = Path(args.fs_dir)
    return opts, storage
