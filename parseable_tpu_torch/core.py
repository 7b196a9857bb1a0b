"""Core service state: options + storage + metastore + stream registry.

Counterpart of `parseable_tpu/core.py` (`Parseable`), trimmed to the query
slice: stream creation and bootstrap from storage, and the upload tick that
moves staged Parquet into the lake and commits it to the manifest/snapshot
catalog exactly as the JAX package does. Ingest, the upload pool, the
enrichment queue and distributed (per-ingestor) snapshots are later slices;
this node runs in `all` mode and writes the base `.stream.json`.
"""

from __future__ import annotations

import logging
import re
from datetime import UTC, datetime, timedelta

import pyarrow as pa
import pyarrow.parquet as pq

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.catalog import (
    Manifest,
    ManifestItem,
    create_from_parquet_file,
    partition_path,
)
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.metastore import MetastoreError, ObjectStoreMetastore
from parseable_tpu_torch.storage import ObjectStoreFormat, rfc3339_now
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
        self.streams = Streams(self.options)

    @property
    def owner_tag(self) -> str:
        """Basename prefix of the parquet this node stages (`<hostname>.`):
        snapshot totals count the manifest files this node owns."""
        return _HOSTNAME + "."

    # --------------------------------------------------------------- streams

    def create_stream_if_not_exists(self, name: str) -> Stream:
        existing = self.streams.get(name)
        if existing is not None:
            return existing
        validate_stream_name(name)
        meta = None
        fmts = self.metastore.get_all_stream_jsons(name)
        if fmts:
            meta = self._metadata_from_format(fmts[0])
            schema = self.metastore.get_schema(name)
            if schema is not None:
                meta.schema = {f.name: f for f in schema}
        if meta is None:
            meta = LogStreamMetadata(created_at=rfc3339_now())
            fmt = ObjectStoreFormat(
                created_at=meta.created_at,
                log_source=[{"log_source_format": "json", "fields": []}],
            )
            self.metastore.put_stream_json(name, fmt)
        return self.streams.get_or_create(name, meta)

    @staticmethod
    def _metadata_from_format(fmt: ObjectStoreFormat) -> LogStreamMetadata:
        return LogStreamMetadata(created_at=fmt.created_at, first_event_at=fmt.first_event_at)

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
        """Merge a schema into the stream schema and persist it."""
        stream = self.get_stream(stream_name)
        current = pa.schema(list(stream.metadata.schema.values()))
        merged = merge_schemas([current, new_schema])
        stream.metadata.schema = {f.name: f for f in merged}
        self.metastore.put_schema(stream_name, merged)

    # ----------------------------------------------------------------- sync

    def upload_files_from_staging(self, stream: Stream) -> list[str]:
        """Upload staged parquet, commit one snapshot update for the batch,
        then delete the staged files.

        Durability ordering: a staged file is unlinked only after the
        snapshot commit succeeds; a failed upload or commit leaves it staged
        for the next cycle (a retried upload replaces the manifest entry by
        file_path, so nothing is counted twice)."""
        files = stream.claim_parquet(stream.parquet_files())
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
        try:
            # the ingest path commits a batch's schema before it stages;
            # here the staged files are the only record of it
            self.commit_schema(stream.name, merge_schemas([s for _, _, s in done]))
            self.update_snapshot(stream, [e for _, e, _ in done])
        except Exception:
            logger.exception("snapshot commit failed for %s; keeping staged parquet", stream.name)
            for f, _, _ in done:
                stream.unclaim_parquet(f)
            return []
        for f, _, _ in done:
            f.unlink(missing_ok=True)
            stream.unclaim_parquet(f)
        return uploaded

    def sync_all_streams(self) -> None:
        """Upload tick over every stream."""
        for name in self.streams.list_names():
            try:
                self.upload_files_from_staging(self.get_stream(name))
            except Exception:
                logger.exception("object store sync failed for %s", name)

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

        Item totals are recomputed from the files this node owns in each
        manifest (staged filenames embed the hostname), so a replayed upload
        of the same file_path leaves them unchanged."""
        try:
            fmt = self.metastore.get_stream_json(stream.name)
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
        self.metastore.put_stream_json(stream.name, fmt)
