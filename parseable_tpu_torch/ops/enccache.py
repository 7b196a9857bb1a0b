"""Encoded-block cache: device-ready columns on local disk.

Counterpart of `parseable_tpu/ops/enccache.py` (`EncodedBlockCache`, :68),
in the same file format byte for byte, so each package reads the entries
the other wrote. The expensive half of a cold scan is Parquet decode +
dictionary encode, pure host work. This cache persists the *canonical
device encoding* (ops/device.py: narrow-dtype dictionary codes, int32 ms
relative to a day-aligned origin, f32 numerics) per scanned Parquet object,
so a cold query's data path becomes file read -> pinned copy -> card.

Written at Parquet upload time (storage/enrichment.py) and as write-behind
whenever a query encodes a block the cache lacks. Keyed by the scan's
content-sensitive source id (path|size|rows), so a rewritten object can't
serve a stale encoding. Entries can hold several VARIANTS per column
((kind, dtype) pairs): a numeric column grouped by in one query stores its
dict-codes variant next to the f32 one.

File format (PTEC3): magic, u32 header length, JSON header {num_rows,
block_rows, time_origin_ms, columns: {name: [variant,...]}} with
per-variant buffer offsets, then raw little-endian buffers stored PADDED
to block_rows (pow2). A read resolves every variant from the header first
(a miss costs no payload I/O), then reads each buffer with one contiguous
read. Eviction is LRU-by-mtime over a byte budget (P_TPU_ENC_CACHE_BYTES,
default 16 GiB).

Write-behind backpressure: the background writer's queue is bounded
(`QUEUE_DEPTH`, the JAX package's default of 16). A producer blocks for at
most `QUEUE_TIMEOUT_S` (250 ms) waiting for room, then the seed is dropped
— COUNTED (`dropped`) and logged, never lost silently.

A read takes the header and the payload through ONE open file: a merge-put
of another variant replaces the file with a longer header, and offsets
from the old header would point at shifted bytes in the new file.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import struct
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from parseable_tpu_torch.ops.device import EncodedBatch, EncodedColumn, f64_base, f64_name, pow2_block

logger = logging.getLogger(__name__)

# PTEC3: time columns are int32 ms relative to a per-batch day-aligned
# origin (header `time_origin_ms`); older entries are stale and unlink at open
_MAGIC = b"PTEC3\n"


def _fname(source_id: bytes) -> str:
    return hashlib.sha1(source_id).hexdigest() + ".enc"


# `_resolve`'s answers for an f64 copy that a column does without: it is
# exact in f32, or it is read as dictionary codes or times
_EXACT = object()
_NOT_NEEDED = object()
# sentinel telling the write-behind thread to exit (EncodedBlockCache.shutdown)
_WRITER_STOP = object()
# write-behind queue bound, and how long a producer waits for room
QUEUE_DEPTH = 16
QUEUE_TIMEOUT_S = 0.25


class EncodedBlockCache:
    def __init__(self, root: Path, budget_bytes: int | None = None):
        self.root = Path(root)
        from parseable_tpu_torch.config import env_int

        self.budget = budget_bytes or env_int("P_TPU_ENC_CACHE_BYTES", 16 << 30)
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        # put() holds the write lock across _put -> _evict_over_budget,
        # which takes the state lock; never acquire them the other way
        # lock-order: EncodedBlockCache._write_lock < EncodedBlockCache._lock
        self._queue: queue.Queue | None = None  # lazily-started background writer
        self._writer: threading.Thread | None = None
        self.hits = 0
        self.misses = 0
        self.dropped = 0  # write-behind seeds shed after the bounded wait
        # stale tmp files from a previous crash and entries of an older
        # format are dead bytes against the budget. Cleanup happens here,
        # once at open: an unlink on the read path could race a concurrent
        # writer's os.replace and delete a freshly written entry.
        try:
            for stale in self.root.glob("*.tmp"):
                stale.unlink(missing_ok=True)
            for f in self.root.glob("*.enc"):
                try:
                    with f.open("rb") as fh:
                        if fh.read(len(_MAGIC)) != _MAGIC:
                            f.unlink(missing_ok=True)
                except OSError:
                    continue
        except OSError:
            pass

    # ------------------------------------------------------------------ put

    def put(self, source_id: bytes, enc: EncodedBatch) -> bool:
        """Persist (merge) a block's encoded columns. Best-effort: failures
        log and return False, never break the query/upload path."""
        try:
            with self._write_lock:
                return self._put(source_id, enc)
        except Exception:  # noqa: BLE001 - a cache write must not fail the caller
            logger.exception("encoded-cache put failed")
            return False

    def put_async(self, source_id: bytes, enc: EncodedBatch) -> None:
        """Write-behind: snapshot the column references (the caller strips
        host arrays right after) and persist on a background thread — the
        merge re-read/rewrite must not sit on the query's cold path.

        Backpressure is deterministic: when the bounded queue is full the
        producer blocks up to QUEUE_TIMEOUT_S for the writer to drain,
        then the seed is dropped — counted and logged (pure cache; the next
        query re-encodes)."""
        snap_cols = {
            name: EncodedColumn(
                c.name, c.kind, c.values, c.valid, c.dictionary,
                all_valid=c.all_valid, vmin=c.vmin, vmax=c.vmax,
            )
            for name, c in enc.columns.items()
        }
        snap = EncodedBatch(
            num_rows=enc.num_rows,
            block_rows=enc.block_rows,
            columns=snap_cols,
            row_mask=enc.row_mask,
            time_origin_ms=enc.time_origin_ms,
            exact_cols=set(enc.exact_cols),
        )
        with self._lock:
            if self._queue is None:
                self._queue = queue.Queue(maxsize=QUEUE_DEPTH)
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    args=(self._queue,),
                    name="enccache-writer",
                    daemon=True,
                )
                self._writer.start()
            q = self._queue
        timeout = QUEUE_TIMEOUT_S
        try:
            if timeout > 0:
                q.put((source_id, snap), timeout=timeout)
            else:
                q.put_nowait((source_id, snap))
        except queue.Full:
            with self._lock:
                self.dropped += 1
                dropped = self.dropped
            # first drop warns (the overload signal); the rest stay debug so
            # a sustained storm can't flood the log — the counter carries
            # the rate either way
            log = logger.warning if dropped == 1 else logger.debug
            log(
                "enccache write-behind queue full after %.0fms wait; "
                "dropped seed (%d dropped so far) — next query re-encodes",
                timeout * 1000,
                dropped,
            )

    def _writer_loop(self, q: queue.Queue) -> None:
        # the queue is a parameter (not self._queue) so shutdown() can drop
        # the attribute without racing this loop's next get()
        while True:
            item = q.get()
            try:
                if item is _WRITER_STOP:
                    return
                source_id, snap = item
                self.put(source_id, snap)
            finally:
                q.task_done()

    def shutdown(self) -> None:
        """Stop the write-behind thread deterministically (pending writes
        drain first). Idempotent; a later put_async restarts the writer."""
        with self._lock:
            q, w = self._queue, self._writer
            self._queue = None
            self._writer = None
        if w is not None and w.is_alive():
            q.put(_WRITER_STOP)
            w.join(timeout=30)

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Block until queued write-behinds have landed (a 'disk-warm' run
        then measures the disk-cache path, not a race with the writer)."""
        q = self._queue
        if q is None:
            return
        deadline = time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                q.all_tasks_done.wait(left)

    def _put(self, source_id: bytes, enc: EncodedBatch) -> bool:
        n = enc.num_rows
        block = enc.block_rows
        path = self.root / _fname(source_id)
        columns: dict[str, list[dict]] = {}
        buffers: list[bytes] = []

        def add_variant(name: str, var: dict, *bufs: bytes) -> None:
            offsets = []
            for b in bufs:
                offsets.append(sum(len(x) for x in buffers))
                buffers.append(b)
            var["offsets"] = offsets
            columns.setdefault(name, []).append(var)

        # carry over existing variants first (their buffers re-read once,
        # through the handle the header came from)
        try:
            f = path.open("rb")
        except FileNotFoundError:
            f = None
        if f is not None:
            with f:
                existing = self._read_header(f)
                if (
                    existing is not None
                    and existing["num_rows"] == n
                    and existing["header"].get("block_rows") == block
                    and existing["header"].get("time_origin_ms") == enc.time_origin_ms
                ):
                    hdr, payload_off = existing["header"], existing["payload_off"]
                    for name, variants in hdr["columns"].items():
                        for v in variants:
                            bufs = []
                            for off, nbytes in zip(v["offsets"], v["nbytes"]):
                                f.seek(payload_off + off)
                                bufs.append(f.read(nbytes))
                            v2 = {k: v[k] for k in v if k != "offsets"}
                            add_variant(name, v2, *bufs)

        changed = False
        for name, col in enc.columns.items():
            if col.values is None or len(col.values) < block:
                continue  # stripped (hot-set) encodings can't be persisted
            key = (col.kind, str(col.values.dtype))
            have = {(v["kind"], v["dtype"]) for v in columns.get(name, [])}
            if key in have:
                continue
            try:
                dict_json = json.dumps(col.dictionary) if col.dictionary is not None else None
            except (TypeError, ValueError):
                continue  # unserializable dictionary values: skip variant
            # a dict variant whose values aren't strings came from force_dict
            # on a numeric/bool column — it must not serve non-group-by reads
            forced = col.kind == "dict" and any(
                v is not None and not isinstance(v, str) for v in (col.dictionary or [])
            )
            # stored PADDED to block_rows
            values = np.ascontiguousarray(col.values[:block])
            col_all_valid = bool(col.valid[:n].all()) if len(col.valid) >= n else True
            var: dict[str, Any] = {
                "kind": col.kind,
                "dtype": str(values.dtype),
                "nbytes": [values.nbytes],
                "all_valid": col_all_valid,
                "dictionary": dict_json,
                "forced": forced,
                "vmin": col.vmin,
                "vmax": col.vmax,
            }
            bufs = [values.tobytes()]
            if not col_all_valid:
                valid = np.ascontiguousarray(col.valid[:block])
                var["nbytes"].append(valid.nbytes)
                bufs.append(valid.tobytes())
            add_variant(name, var, *bufs)
            changed = True
        for name in sorted(enc.exact_cols):
            # the f64 copy a column exact in f32 does without: a marker with
            # no buffer, so that a read that asks for it hits
            if f64_name(name) not in columns:
                add_variant(f64_name(name), {"kind": "f64", "dtype": "float64", "nbytes": [],
                                             "all_valid": True, "dictionary": None,
                                             "forced": False, "exact": True})
                changed = True
        if not changed:
            return False

        header = json.dumps(
            {
                "num_rows": n,
                "block_rows": block,
                "time_origin_ms": enc.time_origin_ms,
                "columns": columns,
            }
        ).encode()
        # unique tmp per writer: concurrent puts for the same source must
        # not truncate each other mid-write (last os.replace wins whole)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        self.root.mkdir(parents=True, exist_ok=True)
        with tmp.open("wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            for b in buffers:
                f.write(b)
        os.replace(tmp, path)
        self._evict_over_budget()
        return True

    # ------------------------------------------------------------------ get

    @staticmethod
    def _pick(variants: list[dict], want_dict: bool) -> dict | None:
        """The variant a read takes: dictionary codes for a group key or a
        distinct column; otherwise the natural (non-dict) variant, or a
        string column's dict variant — never a FORCED dict of a numeric."""
        if want_dict:
            return next((v for v in variants if v["kind"] == "dict"), None)
        pick = next((v for v in variants if v["kind"] != "dict"), None)
        if pick is None:
            pick = next((v for v in variants if v["kind"] == "dict" and not v.get("forced")), None)
        return pick

    @classmethod
    def _resolve(cls, columns: dict, name: str, dict_cols: set[str]):
        """The variant a read of `name` takes, or None for a miss. For the
        f64 copy of a column (`ops/device.py f64_name`): `_EXACT` where the
        entry's marker says the column is exact in f32, `_NOT_NEEDED` where
        the column is read as anything but numbers."""
        base = f64_base(name)
        if base is not None:
            variants = columns.get(base)
            pick = cls._pick(variants, base in dict_cols) if variants else None
            if pick is None:
                return None
            if pick["kind"] != "num":
                return _NOT_NEEDED
            if any(v.get("exact") for v in columns.get(name, ())):
                return _EXACT
        variants = columns.get(name)
        return cls._pick(variants, name in dict_cols) if variants else None

    def get(
        self,
        source_id: bytes,
        needed: set[str] | None,
        dict_cols: set[str],
    ) -> EncodedBatch | None:
        """Rebuild an EncodedBatch for a query's column requirements, or
        None when any needed column/variant is missing."""
        if needed is None:
            return None  # full-projection scans take the live path
        path = self.root / _fname(source_id)
        try:
            fh = path.open("rb")
        except FileNotFoundError:
            self.misses += 1
            return None
        except OSError:
            logger.exception("encoded-cache open failed")
            return None
        with fh:
            batch = self._read_batch(fh, needed, dict_cols)
        if batch is None:
            return None
        try:
            path.touch()  # LRU freshness
        except OSError:
            pass
        self.hits += 1
        return batch

    def _read_batch(self, fh, needed: set[str], dict_cols: set[str]) -> EncodedBatch | None:
        """get()'s read of one open entry: the header, then the payload
        through the same handle."""
        try:
            meta = self._read_header(fh)
        except (OSError, ValueError, KeyError, struct.error):
            logger.exception("encoded-cache header read failed")
            return None
        if meta is None:
            self.misses += 1
            return None
        hdr, payload_off = meta["header"], meta["payload_off"]
        n = hdr["num_rows"]
        block = hdr.get("block_rows") or pow2_block(n)
        cols: dict[str, EncodedColumn] = {}
        # resolve every needed variant from the header FIRST (a miss costs
        # zero payload I/O), then read each buffer with one contiguous read
        picks: dict[str, dict] = {}
        exact: set[str] = set()
        for name in needed:
            pick = self._resolve(hdr["columns"], name, dict_cols)
            if pick is None:
                self.misses += 1
                return None
            if pick is _EXACT:
                exact.add(f64_base(name))
            elif pick is not _NOT_NEEDED:
                picks[name] = pick

        def pread(offset: int, nbytes: int) -> bytes:
            fh.seek(payload_off + offset)
            return fh.read(nbytes)

        try:
            for name, pick in picks.items():
                dt = np.dtype(pick["dtype"])
                values = np.frombuffer(pread(pick["offsets"][0], pick["nbytes"][0]), dtype=dt)
                dictionary = (
                    json.loads(pick["dictionary"]) if pick.get("dictionary") is not None else None
                )
                if pick["all_valid"]:
                    valid = np.ones(block, dtype=bool)
                    valid[n:] = False
                else:
                    valid = np.frombuffer(
                        pread(pick["offsets"][1], pick["nbytes"][1]), dtype=np.bool_
                    )
                cols[name] = EncodedColumn(
                    name,
                    pick["kind"],
                    values,
                    valid,
                    dictionary,
                    all_valid=bool(pick["all_valid"]) and n == block,
                    vmin=pick.get("vmin"),
                    vmax=pick.get("vmax"),
                )
        except (OSError, ValueError, KeyError, IndexError):
            logger.exception("encoded-cache read failed")
            return None
        mask = np.zeros(block, dtype=bool)
        mask[:n] = True
        return EncodedBatch(
            num_rows=n,
            block_rows=block,
            columns=cols,
            row_mask=mask,
            time_origin_ms=int(hdr.get("time_origin_ms", 0)),
            exact_cols=exact,
        )
    def can_serve(self, source_id: bytes, needed: set[str] | None, dict_cols: set[str]) -> bool:
        """Header-only check: would get() succeed? Lets the scan layer skip
        the Parquet read entirely for cache-resident blocks."""
        if needed is None:
            return False
        path = self.root / _fname(source_id)
        try:
            with path.open("rb") as fh:
                meta = self._read_header(fh)
        except (OSError, ValueError, KeyError, struct.error):
            return False
        if meta is None:
            return False
        hdr = meta["header"]
        return all(self._resolve(hdr["columns"], name, dict_cols) is not None for name in needed)

    # ------------------------------------------------------------- internals

    @staticmethod
    def _read_header(f) -> dict | None:
        """The header of an open entry, None for another format. Its
        offsets hold for this open file only: read the payload through the
        same handle."""
        f.seek(0)
        if f.read(len(_MAGIC)) != _MAGIC:
            return None
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        return {
            "header": header,
            "num_rows": header["num_rows"],
            "payload_off": len(_MAGIC) + 4 + hlen,
        }

    def _evict_over_budget(self) -> None:
        with self._lock:
            try:
                files = [(p.stat().st_mtime, p.stat().st_size, p) for p in self.root.glob("*.enc")]
            except OSError:
                return
            total = sum(s for _, s, _ in files)
            if total <= self.budget:
                return
            for _, size, p in sorted(files):
                try:
                    p.unlink()
                    total -= size
                except OSError:
                    pass
                if total <= self.budget:
                    break


_GLOBAL: EncodedBlockCache | None = None
_GLOBAL_ROOT: Path | None = None


def get_enccache(options=None) -> EncodedBlockCache | None:
    """Process-wide cache rooted in the staging dir; None when disabled
    (P_TPU_ENC_CACHE=0)."""
    from parseable_tpu_torch.config import env_str

    global _GLOBAL, _GLOBAL_ROOT
    if env_str("P_TPU_ENC_CACHE", "1") == "0":
        return None
    root: Path | None = None
    if options is not None and getattr(options, "local_staging_path", None) is not None:
        root = Path(options.local_staging_path) / "encoded_cache"
    if _GLOBAL is None or (root is not None and root != _GLOBAL_ROOT):
        if root is None:
            return _GLOBAL
        if _GLOBAL is not None:
            _GLOBAL.shutdown()
        _GLOBAL = EncodedBlockCache(root)
        _GLOBAL_ROOT = root
    return _GLOBAL


def shutdown_enccache() -> None:
    """Stop the process-wide cache's write-behind thread (server shutdown
    hook). The cache itself (disk entries) stays valid for the next start."""
    if _GLOBAL is not None:
        _GLOBAL.shutdown()
