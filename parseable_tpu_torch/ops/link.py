"""Measured link profile: adaptive host/device dispatch.

Counterpart of `parseable_tpu/ops/link.py` (`LinkProfile`, :51, the
background warmer :247-310). The engines record real transfers and host
work into EWMAs, and the GPU executor routes each non-resident block by
estimated cost (`executor_cuda.GpuQueryExecutor._adaptive_gate`):

    ship_cost(bytes)       = h2d latency + bytes / h2d bandwidth
    read_cost(bytes)       = d2h latency + bytes / d2h bandwidth
    cpu_cost(rows)         = rows / measured host aggregation rate
    cpu_filter_cost(rows)  = rows / measured host filter rate

On the card the GPU executor feeds the h2d EWMAs from a sampled,
synchronised block copy (the first and every 8th copy of 1 MiB or more)
and the d2h EWMAs from its timed readbacks; the CPU engine's two-phase
loop and the GPU executor's host-routed blocks feed the host rates. The
device hot set (ops/hotset.py) prices eviction with `ship_cost_per_byte`.
Blocks that lose the estimate fold on the host and are shipped into the
hot set behind the query by the background warmer (`warm_async`), so the
next query runs device-warm either way. Defaults are optimistic (a
healthy link), so the first observations are what teach a slower one.

Profiles persist per staging dir (JSON, the JAX package's file and keys,
so each package reads the other's) so short-lived processes inherit the
measured numbers. `pin_link` installs one profile for every caller while
it is active (tests, and the smoke run's degraded-link phase).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import queue
import threading
import time
from contextlib import contextmanager
from pathlib import Path

logger = logging.getLogger(__name__)

# optimistic defaults: a healthy PCIe gen3 x16-ish link
_DEFAULTS = {
    "h2d_bw": 8e9,  # bytes/sec
    "h2d_lat": 0.002,  # sec per copy
    "d2h_bw": 8e9,
    "d2h_lat": 0.002,
    "cpu_rows_per_sec": 2.0e7,
    "cpu_filter_rows_per_sec": 4.0e7,
}

_SMALL = 256 * 1024  # below this a transfer mostly measures latency
_ALPHA = 0.3  # EWMA weight for new samples
# the gate's routing minimum: smaller blocks always take the device, and
# host work on them measures fixed costs, so it is not recorded
MIN_ROUTED_ROWS = 1 << 16


class LinkProfile:
    def __init__(self, path: Path | None = None):
        self._lock = threading.Lock()
        self._v = dict(_DEFAULTS)
        self._path = path
        self._dirty = False
        self._last_save = 0.0
        # what we last saw on disk: the merge-on-save baseline (keys that
        # moved on disk since = another process's fresher measurements)
        self._last_disk: dict = {}
        if path is not None:
            try:
                if path.exists():
                    stored = json.loads(path.read_text())
                    loaded = {k: float(stored[k]) for k in _DEFAULTS if k in stored}
                    self._v.update(loaded)
                    self._last_disk = loaded
            except (OSError, ValueError, TypeError):
                logger.debug("link profile load failed", exc_info=True)

    # ------------------------------------------------------------- recording

    def _ewma(self, key: str, value: float) -> None:
        self._v[key] = (1 - _ALPHA) * self._v[key] + _ALPHA * value

    def _record_dir(self, lat_key: str, bw_key: str, nbytes: int, secs: float) -> None:
        with self._lock:
            if nbytes < _SMALL:
                self._ewma(lat_key, secs)
            else:
                # subtract the latency estimate, but never let a transfer
                # faster than it fabricate bandwidth: floor at secs/4
                # (inflation bounded to 4x actual)
                eff = nbytes / max(secs - self._v[lat_key], secs / 4)
                self._ewma(bw_key, eff)
            self._dirty = True
        self._maybe_save()

    def record_h2d(self, nbytes: int, secs: float) -> None:
        if secs > 0:
            self._record_dir("h2d_lat", "h2d_bw", nbytes, secs)

    def record_d2h(self, nbytes: int, secs: float) -> None:
        if secs > 0:
            self._record_dir("d2h_lat", "d2h_bw", nbytes, secs)

    def _record_rate(self, key: str, rows: int, secs: float) -> None:
        if secs <= 0 or rows < MIN_ROUTED_ROWS:
            return
        with self._lock:
            self._ewma(key, rows / secs)
            self._dirty = True
        self._maybe_save()

    def record_cpu_agg(self, rows: int, secs: float) -> None:
        """Host aggregation of `rows` block rows, counted before the time
        bounds filter: the basis the gate prices on."""
        self._record_rate("cpu_rows_per_sec", rows, secs)

    def record_cpu_filter(self, rows: int, secs: float) -> None:
        self._record_rate("cpu_filter_rows_per_sec", rows, secs)

    # ------------------------------------------------------------- estimates

    def ship_cost(self, nbytes: int) -> float:
        v = self._v
        return v["h2d_lat"] + nbytes / v["h2d_bw"]

    def ship_cost_per_byte(self, nbytes: int) -> float:
        """Estimated re-ship seconds per resident byte: the hot set's
        eviction score (ops/hotset.py). Amortizing the per-copy latency over
        the block size means small blocks score higher than their bandwidth
        share: evicting them buys back few bytes but costs a whole round
        trip to bring back."""
        return self.ship_cost(nbytes) / max(1, nbytes)

    def read_cost(self, nbytes: int) -> float:
        v = self._v
        return v["d2h_lat"] + nbytes / v["d2h_bw"]

    def cpu_cost(self, rows: int) -> float:
        return rows / self._v["cpu_rows_per_sec"]

    def cpu_filter_cost(self, rows: int) -> float:
        # filters (predicate eval + take) run faster than aggregation;
        # pricing them at the aggregate rate would over-route to the host
        return rows / self._v["cpu_filter_rows_per_sec"]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._v)

    def attach_path(self, path: Path) -> None:
        """Adopt a persistence path without dropping in-memory learning
        (current-session measurements outrank a stored profile)."""
        with self._lock:
            self._path = path
            self._dirty = True
        self._maybe_save()

    # ----------------------------------------------------------- persistence

    def _maybe_save(self) -> None:
        if self._path is None:
            return
        now = time.monotonic()
        with self._lock:
            if not self._dirty or now - self._last_save < 5.0:
                return
            self._dirty = False
            self._last_save = now
        self._do_save()

    def flush(self) -> None:
        """Force a save, bypassing the 5 s throttle, so a short process does
        not exit without persisting what it learned. Registered atexit for
        the process-wide profile; errors are logged, never raised — exit
        paths must not raise."""
        with self._lock:
            if self._path is None or not self._dirty:
                return
            self._dirty = False
            self._last_save = time.monotonic()
        try:
            self._do_save()
        except Exception:  # noqa: BLE001 - an exit path must not raise
            logger.debug("link profile flush failed", exc_info=True)

    def _do_save(self) -> None:
        """Merge-on-save: keys another process moved on disk since our
        last read/write average with ours instead of being clobbered
        last-writer-wins; untouched keys take our (fresher) values."""
        try:
            merged = dict(self._v)
            try:
                stored = json.loads(self._path.read_text())
                for k in _DEFAULTS:
                    if k in stored:
                        sv = float(stored[k])
                        baseline = self._last_disk.get(k)
                        if baseline is None or abs(sv - baseline) > 1e-12:
                            merged[k] = 0.5 * (merged[k] + sv)
            except (OSError, ValueError):
                pass  # no/invalid file: write ours
            # no mkdir: a staging dir that is gone (a deployment torn down
            # before this process exits) is not brought back for the profile
            tmp = self._path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(merged))
            os.replace(tmp, self._path)
            with self._lock:
                self._last_disk = dict(merged)
                self._v.update(merged)
        except OSError:
            logger.debug("link profile save failed", exc_info=True)


_GLOBAL: LinkProfile | None = None
_GLOBAL_PATH: Path | None = None
_PINNED: LinkProfile | None = None


def _flush_at_exit() -> None:
    if _GLOBAL is not None:
        _GLOBAL.flush()


atexit.register(_flush_at_exit)


def get_link(options=None) -> LinkProfile:
    """Process-wide profile, persisted under the staging dir when known.
    A pathless profile that learned first (callers without options) keeps
    its measurements when a path shows up later — it only gains
    persistence. While `pin_link` is active, the pinned profile."""
    global _GLOBAL, _GLOBAL_PATH
    if _PINNED is not None:
        return _PINNED
    path: Path | None = None
    if options is not None and getattr(options, "local_staging_path", None) is not None:
        path = Path(options.local_staging_path) / "link_profile.json"
    if _GLOBAL is None:
        _GLOBAL = LinkProfile(path)
        _GLOBAL_PATH = path
    elif path is not None and _GLOBAL_PATH is None:
        _GLOBAL.attach_path(path)
        _GLOBAL_PATH = path
    elif path is not None and path != _GLOBAL_PATH:
        # a different staging dir is a different deployment
        _GLOBAL = LinkProfile(path)
        _GLOBAL_PATH = path
    return _GLOBAL


@contextmanager
def pin_link(profile: LinkProfile):
    """Make `profile` what every `get_link` call returns until the block
    exits, whatever options the caller passes: the engines price and
    record against it, and the process-wide profile neither learns from
    those queries nor is re-rooted by them. Pins do not nest."""
    global _PINNED
    if _PINNED is not None:
        raise RuntimeError("a link profile is already pinned")
    _PINNED = profile
    try:
        yield profile
    finally:
        _PINNED = None


# ------------------------------------------------------- background warming

_WARM_QUEUE: queue.Queue | None = None
_WARM_THREAD: threading.Thread | None = None
_WARM_PENDING: set = set()  # guarded-by: _WARM_LOCK
_WARM_LOCK = threading.Lock()
_WARM_STOP = object()  # sentinel: drains the warmer loop deterministically


def _warm_loop(q: queue.Queue) -> None:
    # the queue rides in as an argument: shutdown_warmer nulls the global,
    # so the loop keeps draining ITS queue until the stop sentinel arrives
    while True:
        k, f = q.get()
        if k is _WARM_STOP:
            return
        try:
            f()
        except Exception:  # noqa: BLE001 - a failed warm costs only the next query's ship
            logger.debug("background warm failed", exc_info=True)
        finally:
            with _WARM_LOCK:
                _WARM_PENDING.discard(k)


def warm_async(key: tuple, fn) -> bool:
    """Run `fn` (an encode + ship + hot-set put closure) on the warming
    thread. Returns False when the key is already queued or the queue (64)
    is full. A wedged card hangs only this daemon thread, never a query."""
    global _WARM_QUEUE, _WARM_THREAD
    with _WARM_LOCK:
        if key in _WARM_PENDING:
            return False
        if _WARM_QUEUE is None:
            _WARM_QUEUE = queue.Queue(maxsize=64)
            _WARM_THREAD = threading.Thread(
                target=_warm_loop, args=(_WARM_QUEUE,), name="device-warmer", daemon=True
            )
            _WARM_THREAD.start()
        try:
            _WARM_QUEUE.put_nowait((key, fn))
        except queue.Full:
            return False
        _WARM_PENDING.add(key)
        return True


def shutdown_warmer(timeout: float = 10.0) -> None:
    """Stop and join the device-warmer thread. Warms already accepted run
    before the sentinel; a later `warm_async` starts a new warmer.
    Idempotent."""
    global _WARM_QUEUE, _WARM_THREAD
    with _WARM_LOCK:
        q, t = _WARM_QUEUE, _WARM_THREAD
        _WARM_QUEUE = None
        _WARM_THREAD = None
        _WARM_PENDING.clear()
    if q is not None:
        try:
            q.put((_WARM_STOP, None), timeout=timeout)
        except queue.Full:  # wedged full: the daemon flag is the backstop
            logger.warning("device-warmer queue full at shutdown; not drained")
            return
    if t is not None:
        t.join(timeout)
