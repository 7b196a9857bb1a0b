"""Core service state: options + storage + metastore + stream registry.

Counterpart of `parseable_tpu/core.py` (`Parseable`), for one node in any
of the JAX package's modes (`Options.mode`): an `all` or `query` node writes
the base `.stream.json`, an `ingest` node its own
`ingestor.<node_id>.stream.json`, registers itself in the node registry
(`register_node`) and stamps its id after the hostname in the parquet it
stages (`owner_tag`). It owns the staging -> parquet -> object store ->
catalog pipeline, as the JAX package does:

- stream creation, bootstrap from storage and schema commit;
- `local_sync` (flush + compaction on the sync pool) and its pipelined
  variant `sync_cycle` (each parquet uploaded as it lands);
- `upload_files_from_staging` + `update_snapshot`: the manifest/snapshot
  commit, byte-compatible with the JAX package's lake;
- `shutdown`: flush, convert, upload.

Each uploaded Parquet file goes to the enrichment queue after its snapshot
commit (`storage/enrichment.py`), which seeds the encoded-block cache off
the commit path; sync ticks and `shutdown` drain it. The upload pool and remote
backends are later slices.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from datetime import UTC, datetime, timedelta
from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.catalog import (
    Manifest,
    ManifestItem,
    Snapshot,
    create_from_parquet_file,
    partition_path,
)
from parseable_tpu_torch.config import Mode, Options, StorageOptions, generate_node_id
from parseable_tpu_torch.event.format import LogSource, SchemaVersion
from parseable_tpu_torch.metastore import MetastoreError, ObjectStoreMetastore
from parseable_tpu_torch.query.partials import invalidate_result_cache
from parseable_tpu_torch.storage import FullStats, ObjectStoreFormat, rfc3339_now
from parseable_tpu_torch.storage.enrichment import EnrichmentQueue
from parseable_tpu_torch.storage.object_storage import LocalFS
from parseable_tpu_torch.streams import _HOSTNAME, LogStreamMetadata, Stream, Streams
from parseable_tpu_torch.utils.arrowutil import merge_schemas

logger = logging.getLogger(__name__)

_STREAM_NAME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9_-]*$")
_INTERNAL_NAMES = {"pmeta", "pstats"}
MAX_STREAM_NAME_LEN = 100


class StreamError(Exception):
    pass


class StreamNotFound(StreamError):
    pass


def validate_stream_name(name: str) -> None:
    if not name or len(name) > MAX_STREAM_NAME_LEN:
        raise StreamError(f"invalid stream name length: {name!r}")
    if name.lower() in _INTERNAL_NAMES:
        raise StreamError(f"stream name {name!r} is reserved")
    if not _STREAM_NAME_RE.match(name):
        raise StreamError(
            f"stream name {name!r} invalid: must start with a letter and use only "
            "alphanumerics, '-' or '_'"
        )


class Parseable:
    """The service object: one lake, its catalog and its streams."""

    def __init__(self, options: Options | None = None, storage_options: StorageOptions | None = None):
        self.options = options or Options()
        self.storage_options = storage_options or StorageOptions()
        if self.storage_options.backend != "local-store":
            raise ValueError(
                f"storage backend {self.storage_options.backend!r} is not ported yet; "
                "use local-store"
            )
        self.storage = LocalFS(self.storage_options.root)
        self.metastore = ObjectStoreMetastore(self.storage)
        self.node_id = self._load_or_create_node_id()
        self.streams = Streams(self.options, self._node_suffix)
        # shared write-path pool: arrow-group compaction jobs across streams
        # and per-stream upload ticks (P_SYNC_WORKERS)
        self.sync_pool = ThreadPoolExecutor(
            max_workers=max(1, self.options.sync_workers), thread_name_prefix="sync"
        )
        # post-upload encoded-block cache seed, off the commit path
        self.enrichment = EnrichmentQueue(self)
        self._shutdown_done = False

    def _load_or_create_node_id(self) -> str:
        """Node identity persisted in staging, stable across restarts
        (reference: modal/mod.rs:388-452)."""
        path = self.options.staging_dir() / ".node.json"
        if path.is_file():
            try:
                return json.loads(path.read_text())["node_id"]
            except (KeyError, ValueError):
                pass
        node_id = generate_node_id()
        path.write_text(json.dumps({"node_id": node_id, "created_at": rfc3339_now()}))
        return node_id

    def register_node(self, address: str) -> None:
        """Publish this node in the registry (`.parseable/<type>.<id>.json`)
        with the endpoint peers dial, its owner tag and, when this node
        serves the Flight data plane, its `flight_url`. Queriers find
        ingestors here; an entry without `flight_url` keeps peers on HTTP."""
        node_type = {Mode.INGEST: "ingestor", Mode.QUERY: "querier"}.get(self.options.mode, "all")
        if node_type == "ingestor" and self.options.ingestor_endpoint:
            address = self.options.ingestor_endpoint
        elif node_type in ("querier", "all") and self.options.querier_endpoint:
            address = self.options.querier_endpoint
        domain = (
            address
            if address.startswith(("http://", "https://"))
            else f"{self.options.get_scheme()}://{address}"
        )
        node = {
            "node_id": self.node_id,
            "node_type": node_type,
            "domain_name": domain,
            "mode": self.options.mode.to_str(),
            # lets queriers split the manifest set by owner before the
            # pushdown scatter
            "owner_tag": self.owner_tag,
            "registered_at": rfc3339_now(),
        }
        if self.options.flight_port > 0:
            host = urllib.parse.urlsplit(domain).hostname or "127.0.0.1"
            node["flight_url"] = f"grpc://{host}:{self.options.flight_port}"
        self.metastore.put_node(node)

    @property
    def _node_suffix(self) -> str | None:
        """Ingestors write per-node stream jsons; all/query write the base."""
        return self.node_id if self.options.mode == Mode.INGEST else None

    @property
    def owner_tag(self) -> str:
        """Basename prefix of the parquet this node stages
        (`<hostname><ingestor_id>.`, the id on ingest nodes only). Snapshot
        totals count the manifest files this node owns, a pushed-down
        partial scans only them, and a querier skips the files of the peers
        it scatters to: one predicate for all three."""
        return _HOSTNAME + (self._node_suffix or "") + "."

    # --------------------------------------------------------------- streams

    def create_stream_if_not_exists(
        self,
        name: str,
        stream_type: str = "UserDefined",
        log_source: LogSource = LogSource.JSON,
        time_partition: str | None = None,
        custom_partition: str | None = None,
        telemetry_type: str = "logs",
    ) -> Stream:
        existing = self.streams.get(name)
        if existing is not None:
            return existing
        validate_stream_name(name)
        # an existing definition in the object store wins (restart bootstrap)
        meta = None
        fmts = self.metastore.get_all_stream_jsons(name)
        if fmts:
            meta = self._metadata_from_format(fmts[0])
            schema = self.metastore.get_schema(name)
            if schema is not None:
                meta.schema = {f.name: f for f in schema}
            if self._node_suffix is not None:
                # each ingestor owns a per-node stream json for its snapshot
                try:
                    self.metastore.get_stream_json(name, self._node_suffix)
                except MetastoreError:
                    base = ObjectStoreFormat.from_json(fmts[0].to_json())
                    base.snapshot = Snapshot()
                    base.stats = FullStats()
                    self.metastore.put_stream_json(name, base, self._node_suffix)
        if meta is None:
            meta = LogStreamMetadata(
                time_partition=time_partition,
                custom_partition=custom_partition,
                stream_type=stream_type,
                log_source=[log_source],
                telemetry_type=telemetry_type,
                created_at=rfc3339_now(),
            )
            fmt = ObjectStoreFormat(
                created_at=meta.created_at,
                time_partition=time_partition,
                custom_partition=custom_partition,
                stream_type=stream_type,
                log_source=[{"log_source_format": log_source.value, "fields": []}],
                telemetry_type=telemetry_type,
            )
            self.metastore.put_stream_json(name, fmt, self._node_suffix)
        return self.streams.get_or_create(name, meta)

    @staticmethod
    def _metadata_from_format(fmt: ObjectStoreFormat) -> LogStreamMetadata:
        return LogStreamMetadata(
            schema_version=SchemaVersion(fmt.schema_version)
            if fmt.schema_version in ("v0", "v1")
            else SchemaVersion.V1,
            time_partition=fmt.time_partition,
            time_partition_limit_days=int(fmt.time_partition_limit.rstrip("d"))
            if fmt.time_partition_limit
            else None,
            custom_partition=fmt.custom_partition,
            static_schema_flag=fmt.static_schema_flag,
            stream_type=fmt.stream_type,
            log_source=[
                LogSource.from_str(e.get("log_source_format", "json")) for e in fmt.log_source
            ],
            telemetry_type=fmt.telemetry_type,
            created_at=fmt.created_at,
            first_event_at=fmt.first_event_at,
            infer_timestamp=fmt.infer_timestamp,
        )

    def get_stream(self, name: str) -> Stream:
        s = self.streams.get(name)
        if s is None:
            raise StreamNotFound(f"stream {name!r} not found")
        return s

    def load_streams_from_storage(self) -> list[str]:
        """Query-side bootstrap: instantiate every stream known to storage."""
        names = self.metastore.list_streams()
        for name in names:
            if self.streams.contains(name):
                continue
            fmts = self.metastore.get_all_stream_jsons(name)
            if not fmts:
                continue
            meta = self._metadata_from_format(fmts[0])
            schema = self.metastore.get_schema(name)
            if schema is not None:
                meta.schema = {f.name: f for f in schema}
            self.streams.get_or_create(name, meta)
        return names

    def commit_schema(self, stream_name: str, new_schema: pa.Schema) -> None:
        """Merge a schema into the stream schema and persist it
        (reference: event/mod.rs:158). Serialized per stream: concurrent
        ingest workers must not drop each other's new fields."""
        stream = self.get_stream(stream_name)
        with stream.lock:
            current = pa.schema(list(stream.metadata.schema.values()))
            merged = merge_schemas([current, new_schema])
            stream.metadata.schema = {f.name: f for f in merged}
            self.metastore.put_schema(stream_name, merged)

    # ----------------------------------------------------------------- sync

    def local_sync(self, shutdown: bool = False) -> None:
        """Local-sync tick: flush arrows + convert to parquet (sync.rs:244-313).
        Compaction jobs of all streams run concurrently on the sync pool;
        parquet stays staged until the next upload tick. `shutdown` also
        finishes the current minute's writers."""
        self.streams.flush_and_convert(shutdown, pool=self.sync_pool)

    def sync_cycle(self, shutdown: bool = False) -> None:
        """Pipelined local-sync tick (the server's): compaction on the sync
        pool, each finished parquet claimed for upload as it lands, then one
        upload and snapshot commit per stream: staging -> queryable lake
        without waiting for the upload tick."""
        landed: dict[str, tuple[Stream, list[Path]]] = {}
        guard = threading.Lock()

        def on_parquet(stream: Stream, path: Path) -> None:
            with guard:
                landed.setdefault(stream.name, (stream, []))[1].append(path)

        self.streams.flush_and_convert(shutdown, pool=self.sync_pool, on_parquet=on_parquet)
        for stream, files in landed.values():
            try:
                self._upload_claimed(stream, files)
            except Exception:
                logger.exception("pipelined sync failed for %s", stream.name)
        self.enrichment.drain()

    def upload_files_from_staging(self, stream: Stream) -> list[str]:
        """Upload tick for one stream: upload its staged parquet, commit the
        catalog, delete the staged files."""
        return self._upload_claimed(stream, stream.claim_parquet(stream.parquet_files()))

    def _upload_claimed(self, stream: Stream, files: list[Path]) -> list[str]:
        """Upload parquet claimed for this cycle, commit ONE snapshot update
        for the batch, then delete the staged files.

        Durability ordering: a staged file is unlinked only after the
        snapshot commit succeeds; a failed upload or commit leaves it staged
        for the next cycle (a retried upload replaces the manifest entry by
        file_path, so nothing is counted twice). The commit and the unlink
        are one step under the stream lock, so a query reading the staging
        window under that lock sees each file either staged or committed."""
        uploaded: list[str] = []
        done = []
        for f in files:
            key = stream.stream_relative_path(f)
            try:
                self.storage.upload_file(key, f)
                entry = create_from_parquet_file(self.storage.absolute_url(key), f)
                schema = pq.read_schema(f)
            except Exception:
                logger.exception("upload failed for %s; will retry next cycle", f)
                stream.unclaim_parquet(f)
                continue
            done.append((f, entry, schema))
            uploaded.append(key)
        if not done:
            return uploaded
        with stream.lock:
            try:
                # ingest commits a batch's schema before it stages; parquet
                # staged by `Stream.write_parquet` has only this record of it
                self.commit_schema(stream.name, merge_schemas([s for _, _, s in done]))
                self.update_snapshot(stream, [e for _, e, _ in done])
            except Exception:
                logger.exception(
                    "snapshot commit failed for %s; keeping staged parquet", stream.name
                )
                for f, _, _ in done:
                    stream.unclaim_parquet(f)
                return []
            for f, entry, _ in done:
                # the queue takes a hardlink first, so the staged file can
                # go while its background read is still queued
                self.enrichment.submit(stream.name, entry, f)
                f.unlink(missing_ok=True)
                stream.unclaim_parquet(f)
        return uploaded

    def sync_all_streams(self) -> None:
        """Upload tick: every stream syncs concurrently on the sync pool."""
        futs = []
        for name in self.streams.list_names():
            stream = self.streams.get(name)
            if stream is not None:
                futs.append((name, self.sync_pool.submit(self.upload_files_from_staging, stream)))
        for name, fut in futs:
            try:
                fut.result()
            except Exception:
                logger.exception("object store sync failed for %s", name)
        # deterministic cycle end for tests and shutdown; commits never wait here
        self.enrichment.drain()

    def shutdown(self) -> None:
        """Flush staging, convert, upload, then stop the enrichment worker
        and the sync pool (sync.rs:71-86). Idempotent."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self.local_sync(shutdown=True)
        self.sync_all_streams()
        self.enrichment.shutdown()
        self.sync_pool.shutdown(wait=True)

    # --------------------------------------------------------------- catalog

    @staticmethod
    def _file_time_bounds(entry) -> tuple[datetime, datetime]:
        for col in entry.columns:
            if col.name == DEFAULT_TIMESTAMP_KEY and col.stats is not None:
                lo = datetime.fromtimestamp(col.stats.min / 1000, UTC)
                hi = datetime.fromtimestamp(col.stats.max / 1000, UTC)
                return lo, hi
        now = datetime.now(UTC)
        return now, now

    def update_snapshot(self, stream: Stream, entries: list) -> None:
        """Append manifest entries and refresh the stream snapshot.

        The snapshot is this node's stream json (per node on an ingestor).
        Item totals are recomputed from the files this node owns in each
        manifest (staged filenames embed the owner tag), so a replayed
        upload of the same file_path leaves them unchanged, and ingestors
        sharing a minute's manifest each count only their own files."""
        try:
            fmt = self.metastore.get_stream_json(stream.name, self._node_suffix)
        except MetastoreError:
            fmt = ObjectStoreFormat(created_at=stream.metadata.created_at or rfc3339_now())

        batch_paths = {e.file_path for e in entries}
        for entry in entries:
            lower, _upper = self._file_time_bounds(entry)
            day_lower = lower.replace(hour=0, minute=0, second=0, microsecond=0)
            day_upper = day_lower + timedelta(days=1) - timedelta(milliseconds=1)
            prefix = partition_path(stream.name, lower, lower)
            manifest = self.metastore.get_manifest(prefix) or Manifest()
            manifest.apply_change(entry)
            self.metastore.put_manifest(prefix, manifest)

            owned = [
                f
                for f in manifest.files
                if f.file_path in batch_paths
                or f.file_path.rsplit("/", 1)[-1].startswith(self.owner_tag)
            ]
            new_rows = sum(f.num_rows for f in owned)
            new_ingest = sum(f.ingestion_size for f in owned)
            new_size = sum(f.file_size for f in owned)

            manifest_path_full = f"{prefix}/manifest.json"
            item = next(
                (m for m in fmt.snapshot.manifest_list if m.manifest_path == manifest_path_full),
                None,
            )
            if item is None:
                item = ManifestItem(
                    manifest_path=manifest_path_full,
                    time_lower_bound=day_lower,
                    time_upper_bound=day_upper,
                )
                fmt.snapshot.manifest_list.append(item)
            d_rows = new_rows - item.events_ingested
            d_size = new_size - item.storage_size
            item.events_ingested = new_rows
            item.ingestion_size = new_ingest
            item.storage_size = new_size
            fmt.stats.events += d_rows
            fmt.stats.storage += d_size
            fmt.stats.lifetime_events += max(0, d_rows)
            fmt.stats.lifetime_storage += max(0, d_size)

        if fmt.first_event_at is None and stream.metadata.first_event_at:
            fmt.first_event_at = stream.metadata.first_event_at
        self.metastore.put_stream_json(stream.name, fmt, self._node_suffix)
        # the committed snapshot supersedes every cached aggregate interim of
        # this stream (their manifest-set fingerprints are now stale)
        invalidate_result_cache(stream.name)
