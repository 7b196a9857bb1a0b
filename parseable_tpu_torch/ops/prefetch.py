"""Query-aware prefetch: ship block i+1 while block i aggregates.

Counterpart of `parseable_tpu/ops/prefetch.py` (`ScanPrefetcher`, :48). The
scan layer knows the ordered manifest file list before the engine touches a
single row (query/provider.py stubs enccache-servable files in manifest
order). Under memory pressure the hot set can't keep the whole working set
resident, so warm queries repeatedly pay the enccache read + host -> device
copy on the critical path. This module overlaps that cost with compute:
when the executor starts on block *i*, one background thread loads blocks
i+1..i+depth from the encoded-block disk cache and ships them into the
device hot set; on the card it copies on a CUDA stream of its own
(`executor_cuda._prefetch_ship`), and under a mesh of several cards each
card's row shards on a side stream of that card.

Bounding: `depth` (1, the JAX package's default) caps both the lookahead
and the shipped-but-unconsumed window, so prefetch cargo can never hold
more than `depth` blocks of the hot-set budget — without the window, a tight budget
makes the prefetcher's own puts evict its not-yet-consumed cargo. Work the
consumer has already passed is dropped: stale queue entries are discarded
and stale cargo is counted `wasted`.

Contracts:
- `close()` is deterministic: pending work is discarded, a ship already
  in flight completes (its bytes land in the hot set, budget-accounted),
  and the worker thread is joined.
- `claim()` resolves the consumer-vs-prefetcher race on the same block
  without double-shipping: the consumer waits for the scheduled ship.
- hits (prefetched block consumed by the query), wasted ships (prefetched
  but never consumed) and errors (a ship that raised: logged with its
  traceback, and the consumer then ships the block itself) are counted and
  returned by `close()`.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from collections import deque
from typing import Callable

logger = logging.getLogger(__name__)


class ScanPrefetcher:
    """One query's background prefetcher over its ordered stub sources.

    `ship(source_id)` runs on the worker thread; it returns the hot-set
    key it installed, or None when it skipped (already resident, enccache
    miss, over budget). The owning executor must call `close()` when the
    query ends — normally or not (the thread is joined)."""

    def __init__(
        self,
        sources: list[bytes],
        ship: Callable[[bytes], tuple | None],
        depth: int = 1,
    ):
        self._sources = list(sources)
        self._pos = {sid: i for i, sid in enumerate(self._sources)}
        self._ship = ship
        self.depth = max(1, depth)
        self._cond = threading.Condition()
        self._queue: deque = deque()  # guarded-by: self._cond - source ids, block order
        self._scheduled: set = set()  # guarded-by: self._cond - ever enqueued
        self._inflight = None  # guarded-by: self._cond - source mid-ship
        self._shipped: dict = {}  # guarded-by: self._cond - key -> source index
        self._closed = False  # guarded-by: self._cond
        self.issued = 0
        self.hits = 0
        self.wasted = 0
        self.errors = 0
        self._thread = threading.Thread(target=self._loop, name="query-prefetch", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- consumer

    def on_block(self, source_id: bytes) -> None:
        """The executor is starting on `source_id`: drop work it has
        passed, then schedule the next `depth` unscheduled sources."""
        i = self._pos.get(source_id)
        if i is None:
            return
        with self._cond:
            if self._closed:
                return
            # cargo behind the consumer is wasted; queued work strictly
            # behind it is pointless. Block i itself stays queued: claim()
            # is about to wait for exactly that ship.
            for sid in [s for s in self._queue if self._pos.get(s, -1) < i]:
                self._queue.remove(sid)
            stale = [k for k, idx in self._shipped.items() if idx < i]
            for k in stale:
                del self._shipped[k]
                self.wasted += 1
            for j in range(i + 1, min(i + 1 + self.depth, len(self._sources))):
                nxt = self._sources[j]
                if nxt in self._scheduled:
                    continue
                self._scheduled.add(nxt)
                self._queue.append(nxt)
                self.issued += 1
            self._cond.notify_all()

    def consumed(self, key: tuple) -> bool:
        """The executor found `key` hot: was it this prefetcher's ship?
        Consumption frees a slot in the ship-ahead window."""
        with self._cond:
            if key in self._shipped:
                del self._shipped[key]
                self.hits += 1
                self._cond.notify_all()
                return True
            return False

    def claim(self, source_id: bytes, timeout: float = 30.0) -> bool:
        """The consumer needs `source_id` NOW and it isn't hot yet. Wait
        for the scheduled ship to finish (queue order is block order and
        stale entries were dropped in on_block, so at most one ship is
        ahead). Returns True when the prefetcher attempted the ship — the
        caller re-checks the hot set (a skipped/failed ship just means the
        consumer does its own)."""
        with self._cond:
            if source_id not in self._scheduled:
                return False
            deadline = _time.monotonic() + timeout
            while not self._closed and (self._inflight == source_id or source_id in self._queue):
                left = deadline - _time.monotonic()
                if left <= 0:
                    # wedged worker: take the block back
                    if source_id in self._queue:
                        self._queue.remove(source_id)
                        self._scheduled.discard(source_id)
                    return False
                self._cond.wait(left)
            return True

    def close(self) -> dict:
        """Cancel pending prefetches and join the worker (an in-flight
        ship finishes first — after close() returns nothing runs on the
        query's behalf). Idempotent. Returns the outcome counters."""
        with self._cond:
            self._closed = True
            self._queue.clear()
            self._cond.notify_all()
        self._thread.join(timeout=60)
        with self._cond:
            leftover = len(self._shipped)
            if leftover:
                self.wasted += leftover
                self._shipped.clear()
            return {
                "prefetch_issued": self.issued,
                "prefetch_hits": self.hits,
                "prefetch_wasted": self.wasted,
                "prefetch_errors": self.errors,
            }

    # ------------------------------------------------------------------ worker

    def _loop(self) -> None:
        while True:
            with self._cond:
                # ship-ahead window: at most `depth` shipped-but-unconsumed
                # blocks at once (see module docstring)
                while not self._closed and (not self._queue or len(self._shipped) >= self.depth):
                    self._cond.wait()
                if self._closed:
                    return
                sid = self._queue.popleft()
                self._inflight = sid
                self._cond.notify_all()
            key = None
            try:
                key = self._ship(sid)
            except Exception:  # noqa: BLE001 - counted, logged, and the consumer ships
                with self._cond:
                    self.errors += 1
                logger.exception("prefetch ship of %r failed", sid)
            with self._cond:
                self._inflight = None
                if key is not None and not self._closed:
                    self._shipped[key] = self._pos.get(sid, -1)
                self._cond.notify_all()
