"""Query session: SQL text -> plan -> scan -> engine -> result table.

Counterpart of `parseable_tpu/query/session.py` (`QuerySession`, :285),
trimmed to single-stream SELECTs. Engines:

- "gpu" (the default, `Options.query_engine`): `GpuQueryExecutor` on
  `device` (default `cuda`). There is no probe-and-fall-back: a GPU query
  on a machine without a working card raises `DeviceUnavailable`.
  `device="cpu"` runs the same executor with the kernels' plain versions,
  which is how the tests drive it. Aggregates scan with hot stubs
  (`StreamScan.use_hot_stubs`), and `stats.stages.hotset` reports the
  device hot set after the query.
- "cpu": the pyarrow `QueryExecutor`.

On a query-mode node (`Options.mode`) a partializable GROUP BY aggregate
is pushed down to the live ingestors (`query/fanout.py`): each answers a
partial over its own slice, and the merge runs on the CPU engine whatever
the session engine, as in the JAX package. Every other query (selects,
aggregates without GROUP BY, percentiles and distinct counts, and every
query with `P_QUERY_PUSHDOWN=0`) runs the central path on the session
engine, over the ingestors' staging windows pulled by the scan and the
lake. `stats.stages.fanout` reports either.

Both engines share the partial-result cache (`query/partials.py`,
`P_QUERY_RESULT_CACHE_BYTES`): an aggregate whose time range ends before
the staging window, over an unchanged manifest set, is answered from its
cached interim (`stats.stages.result_cache`: "hit", "miss", or None where
the query cannot use the cache).

EXPLAIN, CTEs, UNION, joins and subqueries are later slices and raise
QueryError.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from datetime import UTC, datetime
from typing import Any

import pyarrow as pa
import torch

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.config import Mode
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query import sql as S
from parseable_tpu_torch.query.executor import QueryExecutor
from parseable_tpu_torch.query.partials import (
    get_result_cache,
    manifest_fingerprint,
    plan_fingerprint,
)
from parseable_tpu_torch.query.planner import LogicalPlan, TimeBounds, plan as build_plan
from parseable_tpu_torch.query.provider import StreamScan
from parseable_tpu_torch.utils.arrowutil import record_batches_to_json
from parseable_tpu_torch.utils.timeutil import TimeRange

ENGINES = ("gpu", "cpu")


class QueryError(ValueError):
    pass


@dataclass
class QueryResult:
    table: pa.Table
    fields: list[str]
    stats: dict[str, Any] = field(default_factory=dict)

    def to_json_rows(self) -> list[dict]:
        """Row-major JSON records of the result (the HTTP response body)."""
        return record_batches_to_json(self.table.to_batches())


class _TimedIter:
    """Wraps a scan iterator, accumulating the wall time spent producing
    blocks — the scan share of the stage breakdown (the executor pulls
    lazily, so scan and execute interleave; time inside next() is Parquet
    read/decode not hidden by the read-ahead, the remainder is engine
    work)."""

    def __init__(self, it):
        self._it = iter(it)
        self.seconds = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = _time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.seconds += _time.perf_counter() - t0


class QuerySession:
    """One engine-backed session over a Parseable instance."""

    def __init__(
        self,
        parseable: Parseable,
        engine: str | None = None,
        device: torch.device | str | None = None,
    ):
        self.p = parseable
        self.engine = engine or parseable.options.query_engine
        if self.engine not in ENGINES:
            raise QueryError(f"unknown engine {self.engine!r}; expected one of {ENGINES}")
        self.device = device
        # the statement text the pushdown ships to peers (they plan it
        # again), and the scatter-gather's stats of the last query
        self._exec_sql: str | None = None
        self._fanout_stats: dict | None = None

    def resolve_stream(self, name: str) -> None:
        """Make sure the stream exists locally, loading it from storage when
        this process sees it for the first time."""
        if self.p.streams.get(name) is None:
            self.p.load_streams_from_storage()
        if self.p.streams.get(name) is None:
            raise QueryError(f"stream {name!r} does not exist")

    def query(
        self,
        sql_text: str,
        start_time: str | None = None,
        end_time: str | None = None,
    ) -> QueryResult:
        """Run SQL over the stream it names, bounded by the API time range
        [start_time, end_time) when both are given."""
        t0 = _time.monotonic()
        select = S.parse_sql(sql_text)
        if select.explain or select.ctes or select.set_ops or select.joins or any(
            S.contains_subquery(x)
            for x in [select.where, select.having, *(i.expr for i in select.items)]
        ):
            raise QueryError("EXPLAIN, CTEs, UNION, joins and subqueries are not ported yet")
        lp = self._plan(select, start_time, end_time, t0)
        # GPU aggregates skip the Parquet read of blocks the device hot set
        # or the encoded-block cache holds
        scan = StreamScan(self.p, lp, use_hot_stubs=self.engine == "gpu" and lp.is_aggregate)
        self._exec_sql = sql_text
        self._fanout_stats = None
        table, stats = self._execute(lp, scan)
        stats["stages"]["fanout"] = self._fanout_stage(scan)
        elapsed = _time.monotonic() - t0
        stats.update(
            {
                "elapsed_secs": round(elapsed, 6),
                "engine": self.engine,
                "files_total": scan.stats.files_total,
                "files_pruned": scan.stats.files_pruned,
                "bytes_scanned": scan.stats.bytes_scanned,
                "rows_scanned": scan.stats.rows_scanned,
                "staging_rows": scan.stats.staging_rows,
                # nonzero = files dropped by read failures (partial result)
                "scan_errors": scan.stats.scan_errors,
            }
        )
        return QueryResult(table, table.column_names, stats)

    def _plan(
        self,
        select: S.Select,
        start_time: str | None,
        end_time: str | None,
        t0: float,
    ) -> LogicalPlan:
        lp = build_plan(select)
        self.resolve_stream(lp.stream)
        stream = self.p.streams.get(lp.stream)
        if stream is not None and stream.metadata.schema:
            lp.schema_hint = pa.schema(list(stream.metadata.schema.values()))
        if start_time and end_time:
            tr = TimeRange.parse_human_time(start_time, end_time)
            lp.time_bounds = lp.time_bounds.intersect(TimeBounds(low=tr.start, high=tr.end))
        timeout = self.p.options.query_timeout_secs
        if timeout:
            lp.deadline = t0 + timeout
        lp.memory_limit_bytes = self.p.options.query_memory_limit_bytes
        return lp

    def _execute(self, lp: LogicalPlan, scan: StreamScan) -> tuple[pa.Table, dict]:
        # partial-aggregate result cache: a repeated aggregate over an
        # unchanged manifest set skips the scan, and only HAVING,
        # projection, ORDER BY and LIMIT re-run over the cached interim. A
        # query whose range reaches the staging window cannot use it
        # (staging rows are invisible to the manifest fingerprint). The key
        # is taken before the GPU engine drops the timestamp column below
        result_cache = get_result_cache(self.p.options)
        result_key = None
        if result_cache is not None and lp.is_aggregate and not scan._within_staging_window():
            result_key = (
                lp.stream,
                manifest_fingerprint(scan.manifest_files()),
                plan_fingerprint(lp, self.engine),
            )
            interim = result_cache.get(result_key)
            if interim is not None:
                t0 = _time.perf_counter()
                ex = QueryExecutor(lp)
                _agg, rewritten, _names = ex.build_aggregator()
                table = ex.finalize_from_interim(interim, rewritten)
                stages = {
                    "scan_ms": 0.0,
                    "execute_ms": round((_time.perf_counter() - t0) * 1000, 3),
                    "result_cache": "hit",
                }
                return table, {"stages": stages}
        # the distributed pushdown (query/fanout.py): prepare() scatters a
        # partializable GROUP BY to the live ingestors and re-scopes the
        # scan to the lake files none of them owns; None keeps it central
        dist = None
        opts = self.p.options
        if (
            opts.mode == Mode.QUERY
            and opts.query_pushdown
            and lp.is_aggregate
            and self._exec_sql is not None
        ):
            from parseable_tpu_torch.query import fanout as FO

            dist = FO.prepare(self.p, lp, scan, self._exec_sql)
        if dist is not None:
            # the peers' partials fold into the CPU engine's two-phase merge
            # whatever the session engine, as in the JAX package
            executor = QueryExecutor(lp)
            executor.partials_source = dist.collect
        elif self.engine == "gpu":
            from parseable_tpu_torch.query.executor_cuda import GpuQueryExecutor

            if (
                lp.ts_artificial
                and lp.time_bounds.low is None
                and lp.time_bounds.high is None
                and lp.needed_columns is not None
                and lp.needed_columns - {DEFAULT_TIMESTAMP_KEY}
            ):
                # no bounds and no expression touches the timestamp: skip
                # encoding and shipping it, unless it is the only column read
                # (a table of no columns loses its row count when stamped)
                lp.needed_columns.discard(DEFAULT_TIMESTAMP_KEY)
            self._set_scan_time_hint(lp, scan)
            executor: QueryExecutor = GpuQueryExecutor(lp, self.p.options, device=self.device)
            executor.source_loader = scan.read_source
            # the scan's ordered stub list drives query-aware prefetch:
            # block i+1 ships from the enccache while block i aggregates
            executor.prefetch_scan = scan
        else:
            executor = QueryExecutor(lp)
        if result_key is not None:
            # store the merged interim the moment the engine produces it,
            # but never a partial one (scan_errors: files were dropped)
            def sink(interim: pa.Table) -> None:
                with scan._stats_lock:
                    errors = scan.stats.scan_errors
                if errors == 0:
                    result_cache.put(result_key, interim)

            executor.interim_sink = sink
        timer = _TimedIter(scan.tables())
        t0 = _time.perf_counter()
        table = executor.execute(timer)
        exec_ms = (_time.perf_counter() - t0) * 1000
        if dist is not None:
            self._fanout_stats = dist.stats
        stages = {
            "scan_ms": round(timer.seconds * 1000, 3),
            "execute_ms": round(max(exec_ms - timer.seconds * 1000, 0.0), 3),
            "result_cache": "miss" if result_key is not None else None,
        }
        stats: dict = {"stages": stages}
        routes = getattr(executor, "route_stats", None)
        if routes is not None:
            stats["device_routes"] = dict(routes)
            stages.update({f"{k}_ms": round(v, 3) for k, v in executor.stage_ms.items()})
            stages["hotset"] = self._hotset_stage(routes)
        return table, stats

    def _fanout_stage(self, scan: StreamScan) -> dict | None:
        """stats.stages.fanout: the pushdown's scatter-gather stats where it
        ran, else the central path's staging fan-in (None on a node that is
        not a querier and fetched nothing)."""
        with scan._stats_lock:
            fanin = {
                "fanin_bytes": scan.stats.fanin_bytes,
                "fanin_errors": scan.stats.fanin_errors,
            }
            delegated = scan.stats.files_delegated
            transport = dict(scan.stats.fanin_transport)
        if self._fanout_stats is not None:
            snap = dict(self._fanout_stats)
            snap.update(fanin)
            snap["files_delegated"] = delegated
            # the fallback fan-in's tiers; the scatter's own are "transport"
            if transport:
                snap["fanin_transport"] = transport
            return snap
        if self.p.options.mode != Mode.QUERY and not any(fanin.values()):
            return None
        out = {"mode": "central", **fanin}
        if transport:
            out["transport"] = transport
        return out

    @staticmethod
    def _hotset_stage(routes: dict) -> dict:
        """stats.stages.hotset: the hot set's state (budget, residency,
        evictions, rejections) plus this query's prefetch counters."""
        snap = get_hotset().stats_snapshot()
        for k in ("prefetch_issued", "prefetch_hits", "prefetch_wasted", "prefetch_errors"):
            if k in routes:
                snap[k] = routes[k]
        return snap

    @staticmethod
    def _set_scan_time_hint(lp: LogicalPlan, scan: StreamScan) -> None:
        """Overall scan time range from per-file p_timestamp stats — lets the
        GPU engine pre-size time-bin group capacities exactly."""
        lo_ms = hi_ms = None
        for f in scan.manifest_files():
            for col in f.columns:
                if col.name == DEFAULT_TIMESTAMP_KEY and col.stats is not None:
                    lo_ms = col.stats.min if lo_ms is None else min(lo_ms, col.stats.min)
                    hi_ms = col.stats.max if hi_ms is None else max(hi_ms, col.stats.max)
        if lo_ms is None:
            return
        lo = datetime.fromtimestamp(lo_ms / 1000, UTC)
        hi = datetime.fromtimestamp(hi_ms / 1000, UTC)
        if lp.time_bounds.low is not None:
            lo = max(lo, lp.time_bounds.low)
        if lp.time_bounds.high is not None:
            hi = min(hi, lp.time_bounds.high)
        if lo <= hi:
            lp.scan_time_hint = (lo, hi)
