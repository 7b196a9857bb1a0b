"""Stream scan: the staging window and the lake's Parquet files for one query.

Counterpart of `parseable_tpu/query/provider.py` (`StreamScan`, :487):

- the staging window (`staging_tables`): when the query's range reaches
  into the last two local-sync intervals, this node's `.arrows` and the
  staged parquet not yet committed are read first and row-filtered to the
  range; they carry no source id, so the GPU engine merges them into blocks
  of device size. They are taken under the stream lock together with the
  manifest list, so a row moving from staging into the lake during the
  query is counted once. On a query-mode node the window also holds every
  live ingestor's staging window, pulled over the cluster data plane
  (`server/cluster.py fetch_staging_batches`) after that manifest read;
- the lake: snapshot -> manifests overlapping the time range -> per-file
  time and column-stats pruning (`prune_file`) -> Parquet read from the
  object store. Lake tables yield unfiltered, stamped with a source id; the
  engines apply the row-level time filter themselves.

With `use_hot_stubs` (GPU aggregates), a lake file whose block the device
hot set holds, or the encoded-block cache can serve, is not read: the scan
yields a zero-column stub (`query/stubs.py`) before any Parquet
read, publishes those sources in manifest order (`prefetchable`) for the
executor's prefetcher, and re-reads a source on demand (`read_source`).
`file_filter` scopes the lake to manifest files by basename for the
distributed pushdown (`query/fanout.py`): a peer keeps its own files, the
querier skips the files of the peers it scatters to, and the fallback scan
keeps only a failed peer's; `local_staging` and `fetch_remote_staging`
switch the two halves of the staging window. The hot tier on disk and the
shared scan scheduler are later slices; a small in-order read-ahead
overlaps Parquet decode with the engine.
"""

from __future__ import annotations

import io
import logging
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import UTC, datetime, timedelta
from typing import Callable, Iterator

import pyarrow as pa
import pyarrow.parquet as pq

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY, LOCAL_SYNC_INTERVAL
from parseable_tpu_torch.catalog import ManifestFile, Snapshot
from parseable_tpu_torch.config import Mode
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.ops.enccache import get_enccache
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query.executor import time_bounds_mask
from parseable_tpu_torch.query.planner import LogicalPlan, prune_file
from parseable_tpu_torch.query.stubs import (
    SOURCE_ID_META,
    device_columns,
    dict_group_columns,
    hot_key,
    make_stub,
)
from parseable_tpu_torch.utils.arrowutil import adapt_batch, merge_schemas

logger = logging.getLogger(__name__)

# parquet files decoded ahead of the engine
READ_AHEAD = 2


@dataclass
class ScanStats:
    files_total: int = 0
    files_pruned: int = 0
    bytes_scanned: int = 0
    rows_scanned: int = 0
    # rows of rows_scanned read from the staging window (arrows and staged
    # parquet), before the time filter
    staging_rows: int = 0
    # files dropped from the result set by read/decode failures — nonzero
    # means the response is PARTIAL
    scan_errors: int = 0
    # manifest files left to a peer by `file_filter` (not pruned)
    files_delegated: int = 0
    # the peers' staging windows pulled over the cluster data plane: wire
    # bytes, failed peers, and the bytes and peers per transport tier
    fanin_bytes: int = 0
    fanin_errors: int = 0
    fanin_transport: dict = field(default_factory=dict)


class StreamScan:
    """Materialize a stream's Parquet sources for one query."""

    def __init__(
        self,
        parseable: Parseable,
        plan: LogicalPlan,
        use_hot_stubs: bool = False,
        file_filter: Callable[[str], bool] | None = None,
        local_staging: bool = True,
        fetch_remote_staging: bool = True,
    ):
        self.p = parseable
        self.plan = plan
        # device-resident or enccache-servable blocks skip the Parquet read
        # entirely: the scan yields a stub the GPU executor resolves
        self.use_hot_stubs = use_hot_stubs
        # predicate over a manifest file's basename; files it rejects count
        # as files_delegated
        self.file_filter = file_filter
        # this node's staging window, and (query mode) the peers' windows
        self.local_staging = local_staging
        self.fetch_remote_staging = fetch_remote_staging
        self._sources: dict[bytes, ManifestFile] = {}
        # ordered source ids the scan stubbed: the GPU executor's prefetcher
        # walks this list to ship block i+1 while block i aggregates.
        # Complete before the first stub is yielded
        self.prefetchable: list[bytes] = []
        self._manifest_files: list[ManifestFile] | None = None
        # read-ahead workers update the stats beside the consumer thread
        self.stats = ScanStats()  # guarded-by: self._stats_lock
        self._stats_lock = threading.Lock()

    def merged_snapshot(self) -> Snapshot:
        """Union of all nodes' snapshots for this stream."""
        merged = Snapshot()
        for fmt in self.p.metastore.get_all_stream_jsons(self.plan.stream):
            merged.manifest_list.extend(fmt.snapshot.manifest_list)
        return merged

    def _within_staging_window(self) -> bool:
        """Does the query range touch data still in staging?
        (reference: stream_schema_provider.rs:849-871)."""
        high = self.plan.time_bounds.high
        if high is None:
            return True
        window_start = datetime.now(UTC) - timedelta(seconds=2 * LOCAL_SYNC_INTERVAL)
        return high >= window_start

    def _columns_for_read(self, available: list[str]) -> list[str] | None:
        needed = self.plan.needed_columns
        if needed is None:
            return None
        cols = [c for c in available if c in needed]
        # carry the timestamp column for time filtering — unless the plan
        # dropped it (no bounds, no expression touches it)
        tb = self.plan.time_bounds
        wants_ts = (
            DEFAULT_TIMESTAMP_KEY in needed or tb.low is not None or tb.high is not None
        )
        if wants_ts and DEFAULT_TIMESTAMP_KEY in available and DEFAULT_TIMESTAMP_KEY not in cols:
            cols.append(DEFAULT_TIMESTAMP_KEY)
        return cols

    def manifest_files(self) -> list[ManifestFile]:
        """Manifest entries after time + stats pruning, memoized for the
        scan's lifetime."""
        if self._manifest_files is None:
            self._manifest_files = self._manifest_files_uncached()
        return self._manifest_files

    def _manifest_files_uncached(self) -> list[ManifestFile]:
        """Read the snapshot and prune; the file counts in `stats` describe
        the latest read (the staging window re-reads under the stream lock)."""
        snapshot = self.merged_snapshot()
        items = snapshot.manifests_for_range(self.plan.time_bounds.low, self.plan.time_bounds.high)
        files: list[ManifestFile] = []
        seen: set[str] = set()
        pruned = delegated = 0
        for item in items:
            prefix = item.manifest_path[: -len("/manifest.json")]
            manifest = self.p.metastore.get_manifest(prefix)
            if manifest is None:
                continue
            for f in manifest.files:
                if f.file_path in seen:
                    continue
                seen.add(f.file_path)
                if self.file_filter is not None and not self.file_filter(
                    f.file_path.rsplit("/", 1)[-1]
                ):
                    delegated += 1
                    continue
                if not self._file_overlaps_time(f) or not prune_file(f, self.plan.constraints):
                    pruned += 1
                    continue
                files.append(f)
        with self._stats_lock:
            self.stats.files_total = len(seen)
            self.stats.files_pruned = pruned
            self.stats.files_delegated = delegated
        return files

    def _file_overlaps_time(self, f: ManifestFile) -> bool:
        tb = self.plan.time_bounds
        if tb.low is None and tb.high is None:
            return True
        for col in f.columns:
            if col.name == DEFAULT_TIMESTAMP_KEY and col.stats is not None:
                lo = datetime.fromtimestamp(col.stats.min / 1000, UTC)
                hi = datetime.fromtimestamp(col.stats.max / 1000, UTC)
                if tb.low is not None and hi < tb.low:
                    return False
                if tb.high is not None and lo >= tb.high:
                    return False
        return True

    def _read_parquet(self, f: ManifestFile) -> pa.Table | None:
        """Read a manifest entry with one whole-object GET. Errors drop the
        file from the results but are COUNTED in stats.scan_errors, so a
        partial response is detectable, not silent."""
        try:
            data = self.p.storage.get_object(f.file_path)
            with pq.ParquetFile(io.BytesIO(data)) as pf:
                cols = self._columns_for_read(pf.schema_arrow.names)
                table = pf.read(columns=cols)
        except Exception:
            logger.exception("failed reading parquet %s", f.file_path)
            with self._stats_lock:
                self.stats.scan_errors += 1
            return None
        with self._stats_lock:
            self.stats.bytes_scanned += len(data)
            self.stats.rows_scanned += table.num_rows
        return table

    @staticmethod
    def _stamp(table: pa.Table, source_id: bytes) -> pa.Table:
        meta = dict(table.schema.metadata or {})
        meta[SOURCE_ID_META] = source_id
        return table.replace_schema_metadata(meta)

    def staging_tables(self) -> Iterator[pa.Table]:
        """Staging-window data: this node's unconverted arrows and its
        staged parquet (an upload unlinks it in the step that commits it),
        and on a query-mode node the live ingestors' windows.

        The local window is opened, and the manifest list (re)read, under
        the stream lock: conversions and upload commits move files under
        that lock too, so each local row is seen in exactly one of arrows,
        staged parquet or the manifest. A staged file whose object is
        already in the manifest is skipped. Decoding happens after the lock
        is released (open files stay readable when a sync unlinks them).

        The peers' windows are pulled after that manifest read. A peer
        serves arrows and unclaimed staged parquet, and an unclaimed file
        is not committed, so no peer row is counted twice; a file a peer
        claims for upload, or commits, between the two reads is in neither
        and its rows are missing from this one answer (ROADMAP §3)."""
        stream = self.p.streams.get(self.plan.stream)
        if stream is None:
            return
        batches: list[pa.RecordBatch] = []
        staged: list[tuple[str, pq.ParquetFile]] = []
        try:
            with stream.lock:
                if self.local_staging:
                    batches = stream.staging_batches()
                    for f in stream.parquet_files():
                        staged.append((f, pq.ParquetFile(f)))
                self._manifest_files = self._manifest_files_uncached()
            if self.p.options.mode == Mode.QUERY and self.fetch_remote_staging:
                remote = self._fetch_remote_staging()
                if remote is not None:
                    yield remote
            if batches:
                table = pa.Table.from_batches(batches)
                cols = self._columns_for_read(table.column_names)
                if cols is not None:
                    table = table.select(cols)
                self._count_staging(table.num_rows)
                yield table
            committed = (
                {m.file_path.rsplit("/", 1)[-1] for m in self._manifest_files} if staged else set()
            )
            for f, pf in staged:
                if stream.stream_relative_path(f).rsplit("/", 1)[-1] in committed:
                    continue
                try:
                    t = pf.read(columns=self._columns_for_read(pf.schema_arrow.names))
                except Exception:
                    logger.exception("failed reading staged parquet %s", f.name)
                    with self._stats_lock:
                        self.stats.scan_errors += 1
                    continue
                self._count_staging(t.num_rows)
                yield t
        finally:
            for _, pf in staged:
                pf.close()

    def _count_staging(self, rows: int) -> None:
        with self._stats_lock:
            self.stats.rows_scanned += rows
            self.stats.staging_rows += rows

    def _fetch_remote_staging(self) -> pa.Table | None:
        """Every live ingestor's staging window, bounded by the plan's time
        range and projected to its columns by the peer before it ships
        (reference: airplane.rs:155-184), as one table."""
        from parseable_tpu_torch.server.cluster import fetch_staging_batches

        fanin: dict = {}
        remote = fetch_staging_batches(
            self.p,
            self.plan.stream,
            time_bounds=self.plan.time_bounds,
            columns=self.plan.needed_columns,
            stats=fanin,
        )
        self.add_fanin(fanin)
        if not remote:
            return None
        schema = merge_schemas([b.schema for b in remote])
        table = pa.Table.from_batches([adapt_batch(schema, b) for b in remote])
        cols = self._columns_for_read(table.column_names)
        if cols is not None:
            table = table.select(cols)
        self._count_staging(table.num_rows)
        return table

    def add_fanin(self, fanin: dict) -> None:
        """Fold one fetch's fan-in counters into the scan's stats."""
        with self._stats_lock:
            self.stats.fanin_bytes += fanin.get("bytes", 0)
            self.stats.fanin_errors += fanin.get("errors", 0)
            for k in ("http_bytes", "flight_bytes", "flight_peers", "flight_fallbacks"):
                if fanin.get(k):
                    self.stats.fanin_transport[k] = (
                        self.stats.fanin_transport.get(k, 0) + fanin[k]
                    )

    def _apply_time_filter(self, table: pa.Table) -> pa.Table:
        tb = self.plan.time_bounds
        if (tb.low is None and tb.high is None) or DEFAULT_TIMESTAMP_KEY not in table.column_names:
            return table
        return table.filter(time_bounds_mask(table.column(DEFAULT_TIMESTAMP_KEY), tb.low, tb.high))

    def tables(self) -> Iterator[pa.Table]:
        """The staging window's tables (row-filtered to the time range, no
        source id), then the stubs of cached lake sources, then every other
        pruned lake source, in manifest order, decoded READ_AHEAD files
        ahead of the consumer. Each lake table carries a source id (path,
        size, rows), so a rewritten object at the same path is a new
        source."""
        if self._within_staging_window():
            for t in self.staging_tables():
                t = self._apply_time_filter(t)
                if t.num_rows:
                    yield t
        hotset = enccache = None
        if self.use_hot_stubs:
            hotset = get_hotset()
            enccache = get_enccache(self.p.options)
            needed = device_columns(self.plan.needed_columns, self.plan.select.where)
            dict_cols = dict_group_columns(self.plan.select)
        to_fetch: list[tuple[ManifestFile, bytes]] = []
        stubs: list[tuple[bytes, int]] = []
        for f in self.manifest_files():
            source_id = f"{f.file_path}|{f.file_size}|{f.num_rows}".encode()
            self._sources[source_id] = f
            if hotset is not None:
                entry = hotset.get(hot_key(source_id, needed, dict_cols))
                if entry is not None:
                    stubs.append((source_id, entry.meta.num_rows))
                    continue
                # the encoded-block disk cache: the executor loads
                # device-ready columns, so the Parquet read is skipped
                if enccache is not None and enccache.can_serve(source_id, needed, dict_cols):
                    stubs.append((source_id, f.num_rows))
                    continue
            to_fetch.append((f, source_id))
        # publish the ordered stub list BEFORE the first stub yield (hot-now
        # entries too: under eviction pressure they may be gone by the time
        # the engine gets there, and the prefetcher skips what is resident)
        self.prefetchable = [sid for sid, _ in stubs]
        for source_id, rows in stubs:
            with self._stats_lock:
                self.stats.rows_scanned += rows
            yield make_stub(source_id, rows)
        with ThreadPoolExecutor(max_workers=READ_AHEAD, thread_name_prefix="scan") as pool:
            pending: deque = deque()
            try:
                for f, source_id in to_fetch:
                    pending.append((source_id, pool.submit(self._read_parquet, f)))
                    if len(pending) > READ_AHEAD:
                        yield from self._emit(*pending.popleft())
                while pending:
                    yield from self._emit(*pending.popleft())
            finally:
                for _, fut in pending:
                    fut.cancel()

    def read_source(self, source_id: bytes) -> pa.Table:
        """Re-read a stubbed source (hot-set eviction race / CPU fallback)."""
        f = self._sources.get(source_id)
        if f is None:
            raise KeyError(f"unknown scan source {source_id!r}")
        t = self._read_parquet(f)
        if t is None:
            raise OSError(f"failed to re-read {f.file_path}")
        return self._stamp(t, source_id)

    def _emit(self, source_id: bytes, fut) -> Iterator[pa.Table]:
        t = fut.result()
        if t is not None and t.num_rows:
            yield self._stamp(t, source_id)
