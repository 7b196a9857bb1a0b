"""Staging writers: minute-bucketed Arrow IPC part files + memory buffer.

Counterpart of `parseable_tpu/staging/writer.py`. Parity targets
(reference: src/parseable/staging/writer.rs):
- `DiskWriter`  — appends record batches to a `.part.arrows` IPC file for one
  (schema-key, minute, custom-partition) bucket; `finish()` renames it to
  `.arrows`, making it eligible for parquet conversion (writer.rs:259-327).
- `MemWriter`   — optional bounded in-memory buffer of recent batches kept
  query-visible before conversion (writer.rs:72-113,357-421).
- `Writer`      — owns both plus out-of-window pending writes.

Batches are buffered and written in groups of `disk_write_batch_rows` rows
(reference: DISK_WRITE_BATCH_ROWS) to keep IPC framing overhead low; a batch
of the native columnar lane (payload-sized, on contiguous native buffers) is
written direct, with no regrouping.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from pathlib import Path

import pyarrow as pa
import pyarrow.ipc as ipc

from parseable_tpu_torch.utils.arrowutil import adapt_batch

ARROW_FILE_EXTENSION = "arrows"
PART_FILE_EXTENSION = "part.arrows"


# Explicit IPC write options for the staging files: no compression and the
# current metadata version, stated rather than inherited, so the direct and
# the buffered path provably produce the same framing — recover_orphans and
# the converter read both, and the JAX package's files, identically.
IPC_WRITE_OPTIONS = ipc.IpcWriteOptions()


class DiskWriter:
    """One IPC file for one staging bucket. Not thread-safe; callers lock."""

    def __init__(self, path: Path, schema: pa.Schema, batch_rows: int = 10_000):
        assert str(path).endswith(PART_FILE_EXTENSION), path
        self.path = path
        self.schema = schema
        self.batch_rows = batch_rows
        self.rows_written = 0
        self._pending: list[pa.RecordBatch] = []
        self._pending_rows = 0
        # write-path accounting: direct = straight write_batch from the
        # native buffers, buffered = through the _pending regrouping,
        # adapted = schema-mismatch copies through adapt_batch
        self.direct_writes = 0
        self.buffered_writes = 0
        self.adapted_writes = 0
        path.parent.mkdir(parents=True, exist_ok=True)
        self._sink = pa.OSFile(str(path), "wb")
        self._writer = ipc.new_file(self._sink, schema, options=IPC_WRITE_OPTIONS)
        self.finished = False

    def write(self, batch: pa.RecordBatch, direct: bool = False) -> None:
        if batch.schema != self.schema:
            batch = adapt_batch(self.schema, batch)
            self.adapted_writes += 1
            direct = False  # adapt copied; regroup like any Python-lane batch
        if direct:
            # pending batches (an earlier Python-lane write buffered some)
            # flush first, so row order in the file stays ingestion order
            if self._pending:
                self._flush_pending()
            self._writer.write_batch(batch)
            self.rows_written += batch.num_rows
            self.direct_writes += 1
            return
        self.buffered_writes += 1
        self._pending.append(batch)
        self._pending_rows += batch.num_rows
        if self._pending_rows >= self.batch_rows:
            self._flush_pending()

    def _flush_pending(self) -> None:
        for b in self._pending:
            self._writer.write_batch(b)
            self.rows_written += b.num_rows
        self._pending.clear()
        self._pending_rows = 0

    def finish(self) -> Path | None:
        """Close and rename .part.arrows -> .arrows; returns the final path."""
        if self.finished:
            return None
        self._flush_pending()
        self._writer.close()
        self._sink.close()
        self.finished = True
        if self.rows_written == 0:
            self.path.unlink(missing_ok=True)
            return None
        base = str(self.path)[: -len("." + PART_FILE_EXTENSION)]
        # a bucket can be flushed more than once within its minute (forced
        # flushes, restarts): never overwrite an earlier flush's file
        final = Path(base + "." + ARROW_FILE_EXTENSION)
        n = 0
        while final.exists():
            n += 1
            final = Path(f"{base}.{n}.{ARROW_FILE_EXTENSION}")
        os.replace(self.path, final)
        return final


class MemWriter:
    """Bounded deque of recent batches, snapshot-readable for queries."""

    def __init__(self, max_batches: int = 4096):
        self.max_batches = max_batches
        self._batches: deque[pa.RecordBatch] = deque(maxlen=max_batches)
        self._lock = threading.Lock()

    def push(self, batch: pa.RecordBatch) -> None:
        with self._lock:
            self._batches.append(batch)

    def snapshot(self) -> list[pa.RecordBatch]:
        with self._lock:
            return list(self._batches)

    def clear(self) -> None:
        with self._lock:
            self._batches.clear()


class Writer:
    """Per-stream staging writer set: one DiskWriter per bucket key."""

    def __init__(self, enable_memory: bool = False, batch_rows: int = 10_000):
        self.disk: dict[str, DiskWriter] = {}
        self.mem: MemWriter | None = MemWriter() if enable_memory else None
        self.batch_rows = batch_rows

    def push(
        self, bucket_key: str, path: Path, batch: pa.RecordBatch, direct: bool = False
    ) -> None:
        w = self.disk.get(bucket_key)
        if w is None or w.finished:
            w = DiskWriter(path, batch.schema, self.batch_rows)
            self.disk[bucket_key] = w
        w.write(batch, direct=direct)
        if self.mem is not None:
            self.mem.push(batch)

    def finish_buckets(self, predicate=None) -> list[Path]:
        """Finish writers whose bucket key matches `predicate` (all if None)."""
        done: list[Path] = []
        for key in list(self.disk):
            if predicate is None or predicate(key):
                final = self.disk[key].finish()
                if final is not None:
                    done.append(final)
                del self.disk[key]
        return done
