"""Post-upload enrichment queue: the encoded-block cache seed.

Counterpart of `parseable_tpu/storage/enrichment.py` (`EnrichmentQueue`,
:45), with its seed consumer only (the field-statistics consumer is not
ported yet). Each uploaded Parquet file is decoded once more, encoded to
the device encoding (`ops/device.encode_table`, every column) and written
to the encoded-block cache under its scan source id (`path|size|rows`), so
the first query over the lake after an upload, or after a restart, reads
no Parquet and encodes nothing. An ingest-mode node answers no query on the
card and seeds nothing.

One low-priority worker does this entirely off the commit path: upload
completion and snapshot commits never wait on it. The queue is bounded
(`QUEUE_DEPTH`, the JAX package's default of 64); producers block when it
fills, which backpressures the sync cycle rather than growing without
bound.

Each task owns a hardlink (`<staged-name>.enrich`) made before the
post-commit unlink of the staged Parquet, so the durability path can delete
staged files at once while the queue still has bytes to read. The
`.enrich` suffix keeps the link invisible to `Stream.parquet_files()`;
crash leftovers are removed by `Stream.recover_orphans`.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path

from parseable_tpu_torch.config import Mode

logger = logging.getLogger(__name__)

_STOP = object()
# tasks the queue holds before a producer blocks
QUEUE_DEPTH = 64


@dataclass
class _Task:
    stream_name: str
    entry: object  # catalog ManifestFile of the uploaded Parquet
    path: Path  # hardlink owned by the queue; unlinked after processing


class EnrichmentQueue:
    """Single-worker background queue for per-upload enrichment."""

    def __init__(self, parseable):
        self._p = parseable
        self._q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._worker: threading.Thread | None = None  # guarded-by: self._guard
        self._guard = threading.Lock()

    def _wants_seed(self) -> bool:
        # an ingest node answers no query on the card, so it seeds nothing
        opts = self._p.options
        return opts.mode != Mode.INGEST and opts.query_engine == "gpu"

    # -- producer side ------------------------------------------------------

    def submit(self, stream_name: str, entry, staged_path: Path) -> bool:
        """Queue enrichment for an uploaded Parquet. Called after the
        snapshot commit and before the staged file is unlinked; takes a
        hardlink so the unlink cannot race the background read."""
        if not self._wants_seed():
            return False
        link = staged_path.with_name(staged_path.name + ".enrich")
        try:
            if not link.exists():
                try:
                    os.link(staged_path, link)
                except OSError:
                    shutil.copyfile(staged_path, link)
        except OSError:
            logger.exception("enrichment link failed for %s", staged_path)
            return False
        self._ensure_worker()
        self._q.put(_Task(stream_name, entry, link))
        return True

    def _ensure_worker(self) -> None:
        with self._guard:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run, name="enrich", daemon=True)
                self._worker.start()

    # -- worker side --------------------------------------------------------

    def _run(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is _STOP:
                    return
                self._process(task)
            except Exception:  # noqa: BLE001 - the worker outlives one bad file
                logger.exception("enrichment failed for %s", task.path)
            finally:
                if task is not _STOP:
                    task.path.unlink(missing_ok=True)
                self._q.task_done()

    def _process(self, task: _Task) -> None:
        import pyarrow.parquet as pq

        from parseable_tpu_torch.ops.device import encode_table
        from parseable_tpu_torch.ops.enccache import get_enccache

        if not self._wants_seed():
            return
        cache = get_enccache(self._p.options)
        if cache is None:
            return
        table = pq.read_table(task.path)
        entry = task.entry
        source_id = f"{entry.file_path}|{entry.file_size}|{entry.num_rows}".encode()
        enc = encode_table(table, None)
        if enc is not None:
            cache.put(source_id, enc)

    # -- lifecycle ----------------------------------------------------------

    def drain(self) -> None:
        """Block until every queued task has been processed (sync cycles end
        with this so tests and shutdown see deterministic state; commits
        themselves never wait here)."""
        with self._guard:
            alive = self._worker is not None and self._worker.is_alive()
        if alive:
            self._q.join()

    def shutdown(self) -> None:
        """Drain, then stop the worker thread deterministically."""
        self.drain()
        with self._guard:
            w, self._worker = self._worker, None
        if w is not None and w.is_alive():
            self._q.put(_STOP)
            w.join(timeout=60)
