"""Object-store layout and stream metadata formats.

The layout is identical to the JAX package's (`parseable_tpu/storage/`):

    <stream>/.stream/.stream.json       — per-(node,stream) ObjectStoreFormat
    <stream>/.stream/.schema            — merged Arrow schema (JSON)
    <stream>/date=YYYY-MM-DD/manifest.json
    <stream>/date=YYYY-MM-DD/hour=HH/minute=MM/<file>.parquet
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import UTC, datetime
from typing import Any

from parseable_tpu_torch.catalog import Snapshot

STREAM_METADATA_FILE_NAME = ".stream.json"
STREAM_ROOT_DIRECTORY = ".stream"
# the node registry: `<type>.<node_id>.json` per node (reference: modal/mod.rs)
PARSEABLE_ROOT_DIRECTORY = ".parseable"
SCHEMA_FILE_NAME = ".schema"
MANIFEST_FILE = "manifest.json"

CURRENT_OBJECT_STORE_VERSION = "v7"
CURRENT_SCHEMA_VERSION = "v7"


def rfc3339_now() -> str:
    return datetime.now(UTC).isoformat(timespec="milliseconds").replace("+00:00", "Z")


@dataclass
class FullStats:
    """Current / lifetime / deleted event+storage counters
    (reference: src/stats.rs:40-52)."""

    events: int = 0
    ingestion: int = 0  # bytes of raw json ingested
    storage: int = 0  # bytes of parquet stored
    lifetime_events: int = 0
    lifetime_ingestion: int = 0
    lifetime_storage: int = 0
    deleted_events: int = 0
    deleted_ingestion: int = 0
    deleted_storage: int = 0

    def to_json(self) -> dict:
        return {
            "current_stats": {
                "events": self.events,
                "ingestion": self.ingestion,
                "storage": self.storage,
            },
            "lifetime_stats": {
                "events": self.lifetime_events,
                "ingestion": self.lifetime_ingestion,
                "storage": self.lifetime_storage,
            },
            "deleted_stats": {
                "events": self.deleted_events,
                "ingestion": self.deleted_ingestion,
                "storage": self.deleted_storage,
            },
        }

    @classmethod
    def from_json(cls, obj: dict) -> "FullStats":
        cur = obj.get("current_stats", {})
        life = obj.get("lifetime_stats", {})
        dele = obj.get("deleted_stats", {})
        return cls(
            events=cur.get("events", 0),
            ingestion=cur.get("ingestion", 0),
            storage=cur.get("storage", 0),
            lifetime_events=life.get("events", 0),
            lifetime_ingestion=life.get("ingestion", 0),
            lifetime_storage=life.get("storage", 0),
            deleted_events=dele.get("events", 0),
            deleted_ingestion=dele.get("ingestion", 0),
            deleted_storage=dele.get("storage", 0),
        )


@dataclass
class ObjectStoreFormat:
    """Per-stream metadata (.stream.json; reference storage/mod.rs:128-178)."""

    version: str = CURRENT_OBJECT_STORE_VERSION
    schema_version: str = "v1"
    objectstore_format: str = CURRENT_OBJECT_STORE_VERSION
    created_at: str = field(default_factory=rfc3339_now)
    first_event_at: str | None = None
    owner: dict = field(default_factory=lambda: {"id": "admin", "group": "admin"})
    permissions: list = field(default_factory=lambda: [{"id": "admin", "group": "admin", "access": ["all"]}])
    stats: FullStats = field(default_factory=FullStats)
    snapshot: Snapshot = field(default_factory=Snapshot)
    retention: dict | None = None
    time_partition: str | None = None
    time_partition_limit: str | None = None
    custom_partition: str | None = None
    static_schema_flag: bool = False
    hot_tier_enabled: bool = False
    stream_type: str = "UserDefined"  # UserDefined | Internal
    log_source: list = field(default_factory=list)
    telemetry_type: str = "logs"
    infer_timestamp: bool = True

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "version": self.version,
            "schema_version": self.schema_version,
            "objectstore-format": self.objectstore_format,
            "created-at": self.created_at,
            "owner": self.owner,
            "permissions": self.permissions,
            "stats": self.stats.to_json(),
            "snapshot": self.snapshot.to_json(),
            "hot_tier_enabled": self.hot_tier_enabled,
            "stream_type": self.stream_type,
            "log_source": self.log_source,
            "telemetry_type": self.telemetry_type,
            "infer_timestamp": self.infer_timestamp,
        }
        if self.first_event_at is not None:
            out["first-event-at"] = self.first_event_at
        if self.retention is not None:
            out["retention"] = self.retention
        if self.time_partition is not None:
            out["time_partition"] = self.time_partition
        if self.time_partition_limit is not None:
            out["time_partition_limit"] = self.time_partition_limit
        if self.custom_partition is not None:
            out["custom_partition"] = self.custom_partition
        if self.static_schema_flag:
            out["static_schema_flag"] = True
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "ObjectStoreFormat":
        return cls(
            version=obj.get("version", CURRENT_OBJECT_STORE_VERSION),
            schema_version=obj.get("schema_version", "v0"),
            objectstore_format=obj.get("objectstore-format", CURRENT_OBJECT_STORE_VERSION),
            created_at=obj.get("created-at", rfc3339_now()),
            first_event_at=obj.get("first-event-at"),
            owner=obj.get("owner", {}),
            permissions=obj.get("permissions", []),
            stats=FullStats.from_json(obj.get("stats", {})),
            snapshot=Snapshot.from_json(obj.get("snapshot", {})),
            retention=obj.get("retention"),
            time_partition=obj.get("time_partition"),
            time_partition_limit=obj.get("time_partition_limit"),
            custom_partition=obj.get("custom_partition"),
            static_schema_flag=bool(obj.get("static_schema_flag", False)),
            hot_tier_enabled=obj.get("hot_tier_enabled", False),
            stream_type=obj.get("stream_type", "UserDefined"),
            log_source=obj.get("log_source", []),
            telemetry_type=obj.get("telemetry_type", "logs"),
            infer_timestamp=obj.get("infer_timestamp", True),
        )


def stream_json_path(stream: str, node_id: str | None = None) -> str:
    """Object key of a stream's metadata JSON. Ingestors write
    `.ingestor.<id>.stream.json`, queriers the plain name (modal/mod.rs)."""
    name = f"ingestor.{node_id}{STREAM_METADATA_FILE_NAME}" if node_id else STREAM_METADATA_FILE_NAME
    return f"{stream}/{STREAM_ROOT_DIRECTORY}/{name}"


def schema_path(stream: str) -> str:
    return f"{stream}/{STREAM_ROOT_DIRECTORY}/{SCHEMA_FILE_NAME}"
