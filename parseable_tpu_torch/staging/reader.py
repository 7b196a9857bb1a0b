"""Staging readers: k-way reverse-timestamp merge over Arrow IPC files.

Counterpart of `parseable_tpu/staging/reader.py` (reference:
src/parseable/staging/reader.rs:41-316). `MergedReverseRecordReader` merges several staging `.arrows` files into one
stream of record batches ordered by `p_timestamp` DESC, which is the order
parquet files are written in (newest first — the reference's convention so
recent data appears first in scans).

The reference hand-rolls a reverse-seeking IPC reader over the *stream*
format; we use the IPC *file* format (random-access footer) so reverse batch
iteration is natural. Corrupt/truncated files are skipped, matching the
reference's skip-on-error recovery behavior.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator

import pyarrow as pa
import pyarrow.ipc as ipc

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.utils.arrowutil import adapt_batch, merge_schemas, reverse

logger = logging.getLogger(__name__)


def _open_valid(paths: list[Path]) -> list[ipc.RecordBatchFileReader]:
    readers = []
    for p in paths:
        try:
            readers.append(ipc.open_file(pa.memory_map(str(p))))
        except (pa.ArrowInvalid, pa.ArrowIOError, OSError) as e:
            logger.warning("skipping unreadable staging file %s: %s", p, e)
    return readers


def _batch_reversed(reader: ipc.RecordBatchFileReader) -> Iterator[pa.RecordBatch]:
    """Yield batches last-to-first, each with rows reversed (newest first,
    assuming append order was oldest first)."""
    for i in range(reader.num_record_batches - 1, -1, -1):
        try:
            yield reverse(reader.get_batch(i))
        except (pa.ArrowInvalid, pa.ArrowIOError) as e:
            logger.warning("skipping corrupt batch %d: %s", i, e)


class MergedReverseRecordReader:
    """Merge N staging files into p_timestamp-descending record batches."""

    def __init__(self, paths: list[Path]):
        self.readers = _open_valid(paths)
        schemas = [r.schema for r in self.readers]
        self.schema = merge_schemas(schemas) if schemas else pa.schema([])

    def merged_schema(self) -> pa.Schema:
        return self.schema

    def __iter__(self) -> Iterator[pa.RecordBatch]:
        """K-way merge by head-row timestamp, descending."""
        iters = [_batch_reversed(r) for r in self.readers]
        heads: list[pa.RecordBatch | None] = []
        for it in iters:
            heads.append(next(it, None))

        def head_ts(b: pa.RecordBatch) -> object:
            idx = b.schema.get_field_index(DEFAULT_TIMESTAMP_KEY)
            if idx < 0 or b.num_rows == 0:
                return None
            return b.column(idx)[0].as_py()

        while True:
            best = None
            best_ts = None
            for i, h in enumerate(heads):
                if h is None:
                    continue
                ts = head_ts(h)
                if best is None or (
                    ts is not None and (best_ts is None or ts > best_ts)
                ):
                    best, best_ts = i, ts
            if best is None:
                return
            batch = heads[best]
            heads[best] = next(iters[best], None)
            yield adapt_batch(self.schema, batch)
