"""Stream staging engine + stream registry.

Counterpart of `parseable_tpu/streams.py` (reference:
src/parseable/streams.rs, src/metadata.rs):

- `Stream.push` into minute-bucketed Arrow-IPC writers (streams.rs:235-284)
- partitioned staging filenames                        (streams.rs:286-318)
- `flush` / `prepare_parquet`                          (streams.rs:569-700)
- `convert_disk_files_to_parquet`                      (streams.rs:902-981):
  reverse-merged, stats-bearing parquet, `.part` rename, chunked by
  `max_arrow_files_per_parquet`
- orphan `.part.arrows` recovery                       (streams.rs:1421-1516)
- the `Streams` registry                               (streams.rs:1561-1643)

Staged Parquet is named
`date=D.hour=HH.minute=MM.{custom...}.{host}.{uid}.data.parquet` and uploads
to `<stream>/date=D/hour=HH/minute=MM/{custom.../}{host}.{uid}.data.parquet`,
where `{host}` is the hostname, followed on an ingest-mode node by its
ingestor id: the basename prefix `{host}.` is the node's owner tag
(`Parseable.owner_tag`).

Every move of a stream's rows from one place to the next (open writer ->
`.arrows` -> staged `.parquet` -> lake) becomes visible under `Stream.lock`
in one step, so a reader holding the lock sees each row in exactly one
place; `query/provider.py` reads the staging window that way.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import socket
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import UTC, datetime
from pathlib import Path

import pyarrow as pa
import pyarrow.ipc as ipc
import pyarrow.parquet as pq

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY, OBJECT_STORE_DATA_GRANULARITY
from parseable_tpu_torch.config import Options
from parseable_tpu_torch.event.format import LogSource, SchemaVersion
from parseable_tpu_torch.staging.reader import MergedReverseRecordReader
from parseable_tpu_torch.staging.writer import ARROW_FILE_EXTENSION, PART_FILE_EXTENSION, Writer
from parseable_tpu_torch.utils.timeutil import minute_slot

logger = logging.getLogger(__name__)

_HOSTNAME = re.sub(r"[^A-Za-z0-9_-]", "", socket.gethostname()) or "node"


class StagingError(Exception):
    pass


@dataclass
class LogStreamMetadata:
    """In-memory per-stream metadata (reference: metadata.rs:81-202)."""

    schema: dict[str, pa.Field] = field(default_factory=dict)
    schema_version: SchemaVersion = SchemaVersion.V1
    time_partition: str | None = None
    time_partition_limit_days: int | None = None
    custom_partition: str | None = None
    static_schema_flag: bool = False
    stream_type: str = "UserDefined"
    log_source: list[LogSource] = field(default_factory=list)
    telemetry_type: str = "logs"
    created_at: str = ""
    first_event_at: str | None = None
    infer_timestamp: bool = True


class Stream:
    """One log stream's staging state: writers, files, metadata."""

    def __init__(
        self,
        name: str,
        options: Options,
        metadata: LogStreamMetadata | None = None,
        ingestor_id: str | None = None,
    ):
        self.name = name
        self.options = options
        self.metadata = metadata or LogStreamMetadata()
        # an ingest-mode node's id, stamped after the hostname in every
        # staged file name, so each node's files carry its owner tag
        self.ingestor_id = ingestor_id
        self.data_path = options.staging_dir() / name
        self.writer = Writer(  # guarded-by: self.lock
            enable_memory=options.enable_memory_staging,
            batch_rows=options.disk_write_batch_rows,
        )
        self.lock = threading.RLock()
        # arrows claimed by an in-flight conversion job and parquet claimed by
        # an in-flight upload: concurrent sync cycles must never compact the
        # same arrows twice or upload the same parquet twice
        self._claimed_arrows: set[Path] = set()  # guarded-by: self.lock
        self._claimed_parquet: set[Path] = set()  # guarded-by: self.lock
        # decoded staging window, keyed on the write-once .arrows file set,
        # and the decoded staged parquet of the staging fan-in, per file
        self._staging_cache: tuple | None = None  # guarded-by: self.lock
        self._staged_pq_cache: dict = {}  # guarded-by: self.lock

    @property
    def hostname(self) -> str:
        """The node part of staged file names: hostname + ingestor id."""
        return _HOSTNAME + (self.ingestor_id or "")

    # --- filenames ---------------------------------------------------------

    def filename_by_partition(
        self,
        schema_key: str,
        parsed_timestamp: datetime,
        custom_partition_values: dict[str, str] | None = None,
    ) -> str:
        """Staging filename encoding (schema, minute bucket, partitions, node)
        (reference: streams.rs:286-318)."""
        custom = "".join(
            f"{k}={v}." for k, v in sorted((custom_partition_values or {}).items())
        )
        slot = minute_slot(parsed_timestamp.minute, OBJECT_STORE_DATA_GRANULARITY)
        return (
            f"{schema_key}.date={parsed_timestamp.date()}"
            f".hour={parsed_timestamp.hour:02d}.minute={slot}.{custom}{self.hostname}"
            f".data.{PART_FILE_EXTENSION}"
        )

    # --- push --------------------------------------------------------------

    def push(
        self,
        schema_key: str,
        batch: pa.RecordBatch,
        parsed_timestamp: datetime,
        custom_partition_values: dict[str, str] | None = None,
        direct: bool = False,
    ) -> None:
        """direct=True (native columnar lane): the batch goes straight to
        the bucket's IPC writer without the pending-regroup buffering —
        same file framing, no RecordBatch re-serialization."""
        filename = self.filename_by_partition(schema_key, parsed_timestamp, custom_partition_values)
        bucket_key = filename[: -len("." + PART_FILE_EXTENSION)]
        with self.lock:
            self.writer.push(bucket_key, self.data_path / filename, batch, direct=direct)

    # --- listing -----------------------------------------------------------

    def arrow_files(self) -> list[Path]:
        if not self.data_path.is_dir():
            return []
        return sorted(
            p
            for p in self.data_path.iterdir()
            if p.name.endswith("." + ARROW_FILE_EXTENSION)
            and not p.name.endswith("." + PART_FILE_EXTENSION)
        )

    def parquet_files(self) -> list[Path]:
        if not self.data_path.is_dir():
            return []
        return sorted(
            p
            for p in self.data_path.iterdir()
            if p.suffix == ".parquet" and not p.name.endswith(".part.parquet")
        )

    def unclaimed_parquet_files(self) -> list[Path]:
        """Staged parquet no upload cycle has claimed: provably not yet
        committed to the manifest (a claim is released only after the
        commit and unlink, or after a failure that leaves the file
        uncommitted), so the staging fan-in can serve these rows without
        counting a committed file twice."""
        files = self.parquet_files()
        with self.lock:
            return [f for f in files if f not in self._claimed_parquet]

    def unclaimed_parquet_batches(self) -> list[pa.RecordBatch]:
        """Decoded batches of every unclaimed staged parquet, cached per
        file: staged parquet is written once and deleted after its upload
        commit, never rewritten, so repeated fan-in pulls skip the read.
        Files claimed or deleted since the last call drop out of the cache.
        The caller that needs one consistent cut with `staging_batches`
        holds `lock` around both."""
        files = self.unclaimed_parquet_files()
        out: list[pa.RecordBatch] = []
        fresh: dict[Path, tuple] = {}
        for f in files:
            key = self._fileset_key([f])
            with self.lock:
                hit = self._staged_pq_cache.get(f)
            if key is not None and hit is not None and hit[0] == key:
                fresh[f] = hit
                out.extend(hit[1])
                continue
            try:
                batches = pq.read_table(f).to_batches()
            except FileNotFoundError:
                continue
            except Exception:
                logger.exception("staging fan-in: unreadable staged parquet %s", f)
                continue
            if key is not None:
                fresh[f] = (key, batches)
            out.extend(batches)
        with self.lock:
            self._staged_pq_cache = fresh
        return out

    @staticmethod
    def _fileset_key(files: list[Path]) -> tuple | None:
        """Cache key for a set of write-once staging files; None (= never
        hits) when any file vanished between listing and stat."""
        try:
            return tuple((str(f), st.st_size, st.st_mtime_ns) for f in files for st in (f.stat(),))
        except OSError:
            return None

    def staging_batches(self) -> list[pa.RecordBatch]:
        """Query-visible recent data: the finished `.arrows` of this stream,
        newest first. Current writers are finished first so their IPC
        footers are valid (reference: writer.rs:357-421).

        The files are opened under the lock (memory maps stay readable after
        a conversion unlinks them) and decoded outside it. The decoded window
        is cached on the file set: `.arrows` are write-once (`finish`
        suffixes rather than overwrites), so repeated queries reuse it until a
        flush or a conversion changes the set."""
        with self.lock:
            self.flush(forced=True)
            files = self.arrow_files()
            key = self._fileset_key(files)
            cached = self._staging_cache
            if key is not None and cached is not None and cached[0] == key:
                return list(cached[1])
            reader = MergedReverseRecordReader(files)
        batches = list(reader)
        if len(batches) > 1:
            # the window arrives as per-flush slivers; regroup once (cached)
            # into ~2 MB batches so consumers pay less per-batch overhead
            tbl = pa.Table.from_batches(batches).combine_chunks()
            rows_per = max(1, int((2 << 20) * tbl.num_rows / max(1, tbl.nbytes)))
            batches = tbl.to_batches(max_chunksize=rows_per)
        if key is not None:
            with self.lock:
                self._staging_cache = (key, batches)
        return list(batches)

    # --- flush + convert ---------------------------------------------------

    def flush(self, forced: bool = False) -> list[Path]:
        """Finish disk writers. When not forced, only buckets from minutes
        before the current one are finished (the live minute keeps filling).
        """
        now = datetime.now(UTC)
        current = f"minute={minute_slot(now.minute, OBJECT_STORE_DATA_GRANULARITY)}"
        current_date = f"date={now.date()}.hour={now.hour:02d}"

        def is_past_bucket(key: str) -> bool:
            return not (current in key and current_date in key)

        with self.lock:
            return self.writer.finish_buckets(None if forced else is_past_bucket)

    @staticmethod
    def _arrows_group_key(arrows_name: str) -> str:
        """Arrow files that compact into the same parquet share everything
        except the leading schema key."""
        return arrows_name.split(".", 1)[1].rsplit(".data.", 1)[0]

    def collect_conversion_jobs(self) -> list[tuple[str, list[Path], int]]:
        """Group unclaimed `.arrows` into independent compaction jobs and
        claim their inputs. Each job is one output parquet; claiming under
        the stream lock means two concurrent cycles can never hand the same
        arrows to two jobs (double compaction = duplicated rows)."""
        with self.lock:
            files = [f for f in self.arrow_files() if f not in self._claimed_arrows]
            if not files:
                return []
            groups: dict[str, list[Path]] = {}
            for f in files:
                groups.setdefault(self._arrows_group_key(f.name), []).append(f)
            jobs: list[tuple[str, list[Path], int]] = []
            max_chunk = max(1, self.options.max_arrow_files_per_parquet)
            for group_key, group_files in sorted(groups.items()):
                for ci in range(0, len(group_files), max_chunk):
                    chunk = group_files[ci : ci + max_chunk]
                    jobs.append((group_key, chunk, ci // max_chunk))
                    self._claimed_arrows.update(chunk)
            return jobs

    def run_conversion_job(
        self, group_key: str, chunk: list[Path], part_index: int, claim_output: bool = False
    ) -> Path | None:
        """Execute one claimed compaction job; always releases the claim.
        With `claim_output` the finished parquet is claimed for upload in the
        step that makes it visible (pipeline mode)."""
        try:
            batches = list(MergedReverseRecordReader(chunk))
            if not batches:
                with self.lock:
                    for f in chunk:
                        f.unlink(missing_ok=True)
                return None
            return self._stage_table(
                pa.Table.from_batches(batches),
                group_key,
                suffix=f".{part_index}" if part_index else "",
                consumed=chunk,
                claim_output=claim_output,
            )
        finally:
            with self.lock:
                self._claimed_arrows.difference_update(chunk)

    def convert_disk_files_to_parquet(self) -> list[Path]:
        """Compact finished `.arrows` into parquet (streams.rs:902-981):
        files grouped by (minute bucket, custom partitions, node),
        reverse-merged by p_timestamp, written with per-column stats through
        a `.part.parquet` -> rename protocol; the source arrows go in the
        step that makes the parquet visible."""
        outputs: list[Path] = []
        for group_key, chunk, part_index in self.collect_conversion_jobs():
            out = self.run_conversion_job(group_key, chunk, part_index)
            if out is not None:
                outputs.append(out)
        return outputs

    def _stage_table(
        self,
        table: pa.Table,
        group_key: str,
        suffix: str = "",
        consumed: list[Path] = (),
        claim_output: bool = False,
    ) -> Path:
        """Write `table` as a staged parquet: sorted newest-first by
        p_timestamp (reference: streams.rs:701-764), the configured row-group
        size and compression, per-column stats, a unique id per conversion
        (a deterministic name would let a second conversion of the same
        minute overwrite the first). Renamed into place, with `consumed`
        unlinked, in one step under the lock."""
        if DEFAULT_TIMESTAMP_KEY in table.column_names:
            table = table.sort_by([(DEFAULT_TIMESTAMP_KEY, "descending")])
        self.data_path.mkdir(parents=True, exist_ok=True)
        final = self.data_path / f"{group_key}{suffix}.{uuid.uuid4().hex[:16]}.data.parquet"
        part = final.with_name(final.name + ".part.parquet")
        pq.write_table(
            table,
            part,
            row_group_size=self.options.row_group_size,
            compression=self.options.parquet_compression.to_parquet(),
            write_statistics=True,
        )
        if part.stat().st_size == 0:
            part.unlink()
            raise StagingError(f"wrote empty parquet for {group_key}")
        with self.lock:
            os.replace(part, final)
            if claim_output:
                self._claimed_parquet.add(final)
            for f in consumed:
                f.unlink(missing_ok=True)
        return final

    def write_parquet(self, table: pa.Table, parsed_timestamp: datetime) -> Path:
        """Stage a finished `table` as the parquet of the minute bucket
        holding `parsed_timestamp`, named and written as a conversion would."""
        slot = minute_slot(parsed_timestamp.minute, OBJECT_STORE_DATA_GRANULARITY)
        group_key = (
            f"date={parsed_timestamp.date()}.hour={parsed_timestamp.hour:02d}"
            f".minute={slot}.{self.hostname}"
        )
        return self._stage_table(table, group_key)

    def prepare_parquet(self, shutdown: bool = False) -> list[Path]:
        """flush + convert (reference: streams.rs:569-604)."""
        self.flush(forced=shutdown)
        return self.convert_disk_files_to_parquet()

    # --- upload claims -----------------------------------------------------

    def claim_parquet(self, files: list[Path]) -> list[Path]:
        """Claim staged parquet for one upload cycle; already-claimed files
        are skipped."""
        with self.lock:
            out = [f for f in files if f not in self._claimed_parquet]
            self._claimed_parquet.update(out)
            return out

    def unclaim_parquet(self, f: Path) -> None:
        with self.lock:
            self._claimed_parquet.discard(f)

    def stream_relative_path(self, parquet_path: Path) -> str:
        """Object-store key for a staged parquet file.

        `date=D.hour=HH.minute=MM.{custom...}.{host}.data.parquet` ->
        `<stream>/date=D/hour=HH/minute=MM/{custom.../}{host}.data.parquet`
        """
        parts = parquet_path.name.split(".data.")[0].split(".")
        path_parts: list[str] = []
        tail: list[str] = []
        for p in parts:
            if p.startswith(("date=", "hour=", "minute=")) or ("=" in p and not tail):
                path_parts.append(p)
            else:
                tail.append(p)
        filename = ".".join(tail + ["data", "parquet"])
        return "/".join([self.name, *path_parts, filename])

    # --- recovery ----------------------------------------------------------

    def recover_orphans(self) -> None:
        """Salvage `.part.arrows` left by a crash (streams.rs:1421-1516).

        A part file with a valid IPC footer was fully written minus rename;
        anything unreadable is discarded. Stale `.part.parquet` and
        `.enrich` links are removed.
        """
        if not self.data_path.is_dir():
            return
        for p in list(self.data_path.iterdir()):
            if p.name.endswith(".part.parquet"):
                p.unlink(missing_ok=True)
            elif p.name.endswith(".enrich"):
                # hardlink owned by a previous run's enrichment queue; the
                # data itself was uploaded (links are made post-commit)
                p.unlink(missing_ok=True)
            elif p.name.endswith("." + PART_FILE_EXTENSION):
                try:
                    # validity probe; `with` releases the fd before the rename
                    with ipc.open_file(str(p)) as probe:
                        probe.schema  # noqa: B018
                    final = Path(str(p)[: -len(PART_FILE_EXTENSION)] + ARROW_FILE_EXTENSION)
                    os.replace(p, final)
                except (pa.ArrowInvalid, pa.ArrowIOError, OSError):
                    logger.warning("discarding unrecoverable staging file %s", p)
                    p.unlink(missing_ok=True)


class Streams:
    """Registry of streams by name (reference: streams.rs:1561-1643)."""

    def __init__(self, options: Options, ingestor_id: str | None = None):
        self.options = options
        self.ingestor_id = ingestor_id
        self._streams: dict[str, Stream] = {}  # guarded-by: self._lock
        self._lock = threading.RLock()

    def get(self, name: str) -> Stream | None:
        with self._lock:
            return self._streams.get(name)

    def get_or_create(self, name: str, metadata: LogStreamMetadata | None = None) -> Stream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = Stream(name, self.options, metadata, self.ingestor_id)
                s.recover_orphans()
                self._streams[name] = s
            elif metadata is not None:
                s.metadata = metadata
            return s

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._streams

    def list_names(self) -> list[str]:
        with self._lock:
            return sorted(self._streams)

    def delete(self, name: str) -> None:
        with self._lock:
            s = self._streams.pop(name, None)
        if s is not None:
            shutil.rmtree(s.data_path, ignore_errors=True)

    def flush_and_convert(
        self, shutdown: bool = False, *, pool: ThreadPoolExecutor, on_parquet=None
    ) -> dict[str, list[Path]]:
        """Per-stream flush, then the arrow-group -> parquet jobs of every
        stream concurrently on `pool` (reference: streams.rs:1518-1556).
        `on_parquet(stream, path)` (pipeline mode) runs in the worker as each
        parquet lands, with the output already claimed for upload; a failed
        handoff releases the claim so the upload tick retries the file."""
        with self._lock:
            streams = list(self._streams.values())

        def run_job(s: Stream, group_key: str, chunk: list[Path], part_index: int):
            result = s.run_conversion_job(
                group_key, chunk, part_index, claim_output=on_parquet is not None
            )
            if result is not None and on_parquet is not None:
                try:
                    on_parquet(s, result)
                except Exception:
                    s.unclaim_parquet(result)
                    raise
            return result

        futures = []
        for s in streams:
            try:
                s.flush(forced=shutdown)
                for job in s.collect_conversion_jobs():
                    futures.append((s, pool.submit(run_job, s, *job)))
            except Exception:
                logger.exception("flush_and_convert failed for stream %s", s.name)
        out: dict[str, list[Path]] = {s.name: [] for s in streams}
        for s, fut in futures:
            try:
                result = fut.result()
            except Exception:
                logger.exception("parquet conversion failed for stream %s", s.name)
                continue
            if result is not None:
                out[s.name].append(result)
        return out
