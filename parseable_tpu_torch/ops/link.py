"""Measured link profile: the host -> device transfer rate.

Counterpart of `parseable_tpu/ops/link.py` (`LinkProfile`, :51), its host
-> device half. The engine records real transfers into EWMAs:

    ship_cost(bytes)   = h2d latency + bytes / h2d bandwidth

On the card the GPU executor feeds it from a sampled, synchronised block
copy (the first and every 8th copy of 1 MiB or more); the device hot set
(ops/hotset.py) prices eviction with `ship_cost_per_byte`. Defaults are
optimistic (a healthy PCIe link), so the first observations are what teach
a slower one. The device -> host and CPU-rate EWMAs, the background warmer
and the adaptive host/device gate that reads them are not ported yet.

Profiles persist per staging dir (JSON, the JAX package's file and its h2d
keys) so short-lived processes inherit the measured numbers.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

# optimistic defaults: a healthy PCIe gen3 x16-ish link
_DEFAULTS = {
    "h2d_bw": 8e9,  # bytes/sec
    "h2d_lat": 0.002,  # sec per copy
}

_SMALL = 256 * 1024  # below this a transfer mostly measures latency
_ALPHA = 0.3  # EWMA weight for new samples


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

    def record_h2d(self, nbytes: int, secs: float) -> None:
        if secs <= 0:
            return
        with self._lock:
            if nbytes < _SMALL:
                self._ewma("h2d_lat", secs)
            else:
                # subtract the latency estimate, but never let a transfer
                # faster than it fabricate bandwidth: floor at secs/4
                # (inflation bounded to 4x actual)
                eff = nbytes / max(secs - self._v["h2d_lat"], secs / 4)
                self._ewma("h2d_bw", eff)
            self._dirty = True
        self._maybe_save()

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
        last-writer-wins; untouched keys take our (fresher) values. Keys
        this profile does not learn (the JAX package's d2h and CPU rates)
        are written back as they were."""
        try:
            merged = dict(self._v)
            stored: dict = {}
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
            tmp.write_text(json.dumps({**stored, **merged}))
            os.replace(tmp, self._path)
            with self._lock:
                self._last_disk = dict(merged)
                self._v.update(merged)
        except OSError:
            logger.debug("link profile save failed", exc_info=True)


_GLOBAL: LinkProfile | None = None
_GLOBAL_PATH: Path | None = None


def _flush_at_exit() -> None:
    if _GLOBAL is not None:
        _GLOBAL.flush()


atexit.register(_flush_at_exit)


def get_link(options=None) -> LinkProfile:
    """Process-wide profile, persisted under the staging dir when known.
    A pathless profile that learned first (callers without options) keeps
    its measurements when a path shows up later — it only gains
    persistence."""
    global _GLOBAL, _GLOBAL_PATH
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
