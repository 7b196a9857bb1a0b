"""Distributed query fan-out: partial-aggregate pushdown and scatter-gather.

Counterpart of `parseable_tpu/query/fanout.py` (reference:
handlers/http/cluster/mod.rs:1785-1964, airplane.rs do_get). Instead of
pulling every ingestor's raw staging window and scanning all Parquet
centrally, a query-mode node scatters the statement and its resolved time
bounds to the live ingestors. Each peer scans its own slice (its staging
window plus the manifest files it owns, by the basename owner tag) into
partial aggregates and answers ONE combined partial table (`__g*`, `__cnt`,
`__pac`, `__sum`, `__sumsq`, `__min`, `__max`) as Arrow IPC or over Flight.
The querier folds the peers' partials into its own scan's per-block
partials and finalizes through `merge_partials` and
`finalize_from_interim`, so avg and stddev stay exact (the wire carries
(count, sum[, sumsq]) state, never finalized values).

The scatter-gather:
- gathers in completion order;
- keeps at most `P_FANOUT_MAX_INFLIGHT` requests in flight;
- gives each peer `P_FANOUT_TIMEOUT_MS` and ONE retry on a retryable error;
- hedges (`P_FANOUT_HEDGE_MS`): a duplicate request to a peer whose first
  attempt is still out; the first answer wins and the other is dropped, so
  no peer contributes twice;
- serves a peer that answers 404 (an older build), rejects the plan, times
  out or answers with another owner tag through the CENTRAL path for its
  slice alone: its staging window over the bounded fan-in, and a local
  scan of the manifest files it owns. A failure degrades to the central
  data plane without dropping or duplicating a group.

Only single-stream GROUP BY aggregates whose specs are partializable
(`partials.PARTIALIZABLE_FUNCS`) scatter; everything else stays on the
central path, where the session's engine (the card, by default) answers.
The merge of a pushed-down aggregate runs the CPU engine whatever the
session engine, as in the JAX package, and so does a peer's scan.

The JAX module's telemetry spans and Prometheus counters are not ported;
`DistributedRun.stats` (the querier's `stats.stages.fanout`) is.
"""

from __future__ import annotations

import io
import json
import logging
import queue as _queue
import time as _time
import urllib.error
from typing import TYPE_CHECKING

import pyarrow as pa
import pyarrow.ipc as ipc

if TYPE_CHECKING:  # pragma: no cover - typing only
    from parseable_tpu_torch.core import Parseable
    from parseable_tpu_torch.query.planner import LogicalPlan
    from parseable_tpu_torch.query.provider import StreamScan

logger = logging.getLogger(__name__)

PARTIAL_PATH = "/api/v1/internal/query/partial"

# response headers carrying the peer's scan accounting and identity
H_ROWS = "X-P-Rows-Scanned"
H_ERRORS = "X-P-Scan-Errors"
H_TAG = "X-P-Owner-Tag"


class UnsupportedPartial(Exception):
    """The statement cannot run as a node-local partial (not a GROUP BY, an
    aggregate with no partial form, a composite query): the peer answers
    400 and the querier serves that peer's slice centrally."""


def serialize_table(table: pa.Table) -> bytes:
    sink = io.BytesIO()
    with ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def deserialize_table(data: bytes) -> pa.Table:
    with ipc.open_stream(io.BytesIO(data)) as reader:
        return reader.read_all()


# --------------------------------------------------------------- peer side


def execute_local_partial(
    p: "Parseable", stream_name: str, sql: str, start: str | None, end: str | None
) -> tuple[bytes, dict] | None:
    """The HTTP shape of `execute_local_partial_table`: (IPC payload, meta),
    the payload b"" when the node-local slice is empty, or None when this
    node does not know the stream."""
    out = execute_local_partial_table(p, stream_name, sql, start, end)
    if out is None:
        return None
    table, meta = out
    if table is None:
        return b"", meta
    return serialize_table(table), meta


def execute_local_partial_table(
    p: "Parseable", stream_name: str, sql: str, start: str | None, end: str | None
) -> tuple[pa.Table | None, dict] | None:
    """The node-local half of a pushed-down aggregate: scan this node's
    staging window (arrows AND staged parquet not yet uploaded: the querier
    delegated this node's whole slice) plus the manifest files it owns,
    reduce to per-block partials on the CPU engine, and combine them into
    one partial table.

    Shared by the HTTP route (which serializes to IPC) and the Flight
    `partial` ticket. Returns (table or None, meta), the table None when
    the slice is empty, or None when this node does not know the stream.
    Raises UnsupportedPartial for plans the partial protocol cannot
    express."""
    from parseable_tpu_torch.query import partials as PT
    from parseable_tpu_torch.query import sql as S
    from parseable_tpu_torch.query.executor import QueryExecutor
    from parseable_tpu_torch.query.provider import StreamScan
    from parseable_tpu_torch.query.session import QueryError, QuerySession

    t0 = _time.monotonic()
    try:
        select = S.parse_sql(sql)
    except S.SqlError as e:
        raise UnsupportedPartial(f"unparseable statement: {e}") from e
    if select.ctes or select.set_ops or select.joins or select.explain:
        raise UnsupportedPartial("composite statements are not partializable")
    if select.table != stream_name:
        raise UnsupportedPartial("statement stream does not match the route")

    sess = QuerySession(p, engine="cpu")
    try:
        lp = sess._plan(select, start, end, t0)
    except QueryError:
        # unknown stream on this node: no staging, no owned files
        return None

    ex = QueryExecutor(lp)
    agg, _rewritten, _names = ex.build_aggregator()
    if not (lp.is_aggregate and lp.select.group_by and PT.specs_partializable(agg.specs)):
        raise UnsupportedPartial("plan is not a partializable GROUP BY aggregate")

    tag = p.owner_tag
    meta = {"owner_tag": tag, "rows_scanned": 0, "scan_errors": 0}
    scan = StreamScan(
        p,
        lp,
        file_filter=lambda basename: basename.startswith(tag),
        fetch_remote_staging=False,
    )
    tables = scan.tables()
    rows_seen = [0]

    def counted():
        # count what flowed into the reduction: staging and lake alike
        for t in tables:
            rows_seen[0] += t.num_rows
            yield t

    try:
        parts = ex.partial_tables(counted())
    finally:
        tables.close()
    meta["rows_scanned"] = rows_seen[0]
    with scan._stats_lock:
        meta["scan_errors"] = scan.stats.scan_errors
    if not parts:
        return None, meta
    return PT.combine_partials(parts, agg.specs, len(lp.select.group_by)), meta


# ------------------------------------------------------------ querier side


class _PeerState:
    """The gather's record of one scattered peer. Only the collector
    thread changes it; attempt workers report through the queue."""

    def __init__(self, node: dict):
        self.node = node
        self.domain = node["domain_name"]
        self.tag = node["owner_tag"]
        self.issued = 0
        self.resolved = 0
        self.retried = False
        self.hedged = False
        self.first_sent_at: float | None = None
        self.done = False  # a result was merged
        self.failed = False  # exhausted: central fallback
        self.fail_reason: str | None = None
        self.elapsed_ms: float | None = None
        self.bytes = 0
        self.rows = 0  # rows the peer reports it scanned
        self.transport: str | None = None  # "flight" | "http" once done


class DistributedRun:
    """One query's scatter-gather. `start()` launches the bounded fan-out
    on the cluster pool; `collect()`, which the executor calls once the
    local scan has reduced, gathers the peers' partials in completion
    order, applies the retry and hedge policy, runs the central fallback
    for failed peers, and returns the partial tables to merge."""

    def __init__(
        self, p: "Parseable", lp: "LogicalPlan", scan: "StreamScan", peers: list[dict], body: dict
    ):
        self.p = p
        self.lp = lp
        self.scan = scan
        self.opts = p.options
        self.body = json.dumps(body).encode()
        self.body_dict = body  # reused as the Flight partial ticket
        self.peers = [_PeerState(n) for n in peers]
        self._q: _queue.Queue = _queue.Queue()
        self._deferred: list[_PeerState] = []
        # workers add under the GIL; read only after collect() drained the queue
        self._flight_declines = 0
        self.stats: dict = {
            "mode": "pushdown",
            "peers": len(peers),
            "ok": 0,
            "fallback": 0,
            "hedged": 0,
            "retries": 0,
            "bytes": 0,
            "fallback_fanin_bytes": 0,
            "per_peer": {},
        }

    # ---------------------------------------------------------- dispatch

    def start(self) -> None:
        max_inflight = max(1, self.opts.fanout_max_inflight)
        for st in self.peers[:max_inflight]:
            self._submit(st, "initial")
        self._deferred = list(self.peers[max_inflight:])

    def _submit(self, st: _PeerState, kind: str) -> None:
        from parseable_tpu_torch.server.cluster import get_cluster_pool

        st.issued += 1
        if st.first_sent_at is None:
            st.first_sent_at = _time.monotonic()
        get_cluster_pool().submit(self._attempt, st, kind)

    def _attempt(self, st: _PeerState, kind: str) -> None:
        """Worker side: one round trip down the transport ladder, Flight
        where the peer advertises it and, on ANY Flight failure, HTTP.
        Every outcome posts exactly one queue record."""
        from parseable_tpu_torch.server import cluster as C

        timeout = max(0.1, self.opts.fanout_timeout_ms / 1000.0)
        t0 = _time.monotonic()
        location = C.flight_location(self.p, st.node)
        if location is not None:
            try:
                table, headers = self._flight_attempt(location, timeout)
                self._q.put((st, True, table, headers, _time.monotonic() - t0, kind))
                return
            except Exception as e:  # noqa: BLE001 - decline to HTTP
                C.get_flight_pool().invalidate(location)
                self._flight_declines += 1
                logger.warning(
                    "flight pushdown to %s declined (%s), retrying over HTTP: %s",
                    st.domain, kind, e,
                )
        url = f"{st.domain}{PARTIAL_PATH}/{self.lp.stream}"
        try:
            with C._http(self.p, "POST", url, self.body, timeout=timeout) as resp:
                data = resp.read()
                headers = {
                    "rows_scanned": int(resp.headers.get(H_ROWS, 0) or 0),
                    "scan_errors": int(resp.headers.get(H_ERRORS, 0) or 0),
                    "owner_tag": resp.headers.get(H_TAG, ""),
                    "status": resp.status,
                    "transport": "http",
                    "wire_bytes": len(data),
                }
            self._q.put((st, True, data, headers, _time.monotonic() - t0, kind))
        except urllib.error.HTTPError as e:
            # 404 = no such route (older peer), 400 = plan rejected: both
            # final for this query; 5xx is retryable
            e.close()
            self._q.put((st, False, e.code, None, _time.monotonic() - t0, kind))
        except (urllib.error.URLError, OSError, ValueError) as e:
            self._q.put((st, False, e, None, _time.monotonic() - t0, kind))

    def _flight_attempt(self, location: str, timeout: float):
        """One DoGet with the partial ticket. The peer's accounting rides
        as `ptpu.*` schema metadata (`server/flight.py`), stripped before
        the merge so the table is the HTTP tier's. Raises on any failure:
        the caller declines to HTTP."""
        import pyarrow.flight as fl

        from parseable_tpu_torch.server import cluster as C
        from parseable_tpu_torch.server.flight import (
            META_EMPTY,
            META_ERRORS,
            META_OWNER_TAG,
            META_ROWS,
            strip_flight_meta,
        )

        ticket = dict(self.body_dict, kind="partial", stream=self.lp.stream)
        client = C.get_flight_pool().get(location)
        reader = client.do_get(
            fl.Ticket(json.dumps(ticket).encode()), C._flight_call_options(self.p, timeout)
        )
        table = reader.read_all()
        meta = table.schema.metadata or {}
        headers = {
            "rows_scanned": int(meta.get(META_ROWS, b"0") or 0),
            "scan_errors": int(meta.get(META_ERRORS, b"0") or 0),
            "owner_tag": (meta.get(META_OWNER_TAG) or b"").decode(),
            "status": 200,
            "transport": "flight",
        }
        if meta.get(META_EMPTY) == b"1" or table.num_columns == 0:
            headers["wire_bytes"] = 0
            return None, headers
        headers["wire_bytes"] = table.nbytes
        # gRPC hands the buffers over at any offset, and the merge's Acero
        # group_by warns on (and may slow down at) unaligned input: one copy
        # of a partial table (one row a group) through IPC realigns them
        return deserialize_table(serialize_table(strip_flight_meta(table))), headers

    # ------------------------------------------------------------ gather

    def collect(self) -> list[pa.Table]:
        """Gather in completion order, then the central fallback. Runs on
        the executor's thread once the local blocks have reduced; the peers
        have been working since `start()`."""
        tables: list[pa.Table] = []
        timeout_s = max(0.1, self.opts.fanout_timeout_ms / 1000.0)
        hedge_s = self.opts.fanout_hedge_ms / 1000.0
        deadline = _time.monotonic() + 2 * timeout_s + max(hedge_s, 0.0) + 2.0
        if self.lp.deadline is not None:
            deadline = min(deadline, self.lp.deadline)

        while True:
            pending = [st for st in self.peers if not st.done and not st.failed]
            if not pending:
                break
            now = _time.monotonic()
            if now >= deadline:
                for st in pending:
                    self._fail(st, "timeout")
                break
            # hedging: duplicate a peer still outstanding past the hedge
            # delay; the first answer wins, the other is dropped
            next_timer = deadline
            if hedge_s > 0:
                for st in pending:
                    if st.first_sent_at is None or st.hedged:
                        continue
                    due = st.first_sent_at + hedge_s
                    if now >= due:
                        st.hedged = True
                        self.stats["hedged"] += 1
                        self._submit(st, "hedge")
                    else:
                        next_timer = min(next_timer, due)
            try:
                item = self._q.get(timeout=max(0.02, next_timer - now))
            except _queue.Empty:
                continue
            self._handle(item, tables)

        fallback = [st for st in self.peers if st.failed]
        if fallback:
            tables.extend(self._fallback_partials(fallback))
        transport: dict = {}
        for st in self.peers:
            if st.done and st.transport:
                transport[st.transport] = transport.get(st.transport, 0) + 1
            self.stats["per_peer"][st.domain] = {
                "result": "ok" if st.done else (st.fail_reason or "failed"),
                "ms": round(st.elapsed_ms, 3) if st.elapsed_ms is not None else None,
                "bytes": st.bytes,
                "rows": st.rows,
                "attempts": st.issued,
                "hedged": st.hedged,
                "transport": st.transport,
            }
        if self._flight_declines:
            transport["flight_declines"] = self._flight_declines
        self.stats["transport"] = transport
        return tables

    def _handle(self, item, tables: list[pa.Table]) -> None:
        st, ok, payload, headers, elapsed, kind = item
        st.resolved += 1
        if st.done or st.failed:
            # a hedge or retry that lost, or a straggler past the deadline
            # whose slice the fallback covers: dropping it is what keeps
            # every group counted once
            return
        if ok:
            if headers["owner_tag"] != st.tag:
                # the peer answered under another identity than the registry
                # promised: merging would count what lies outside its scope
                logger.warning(
                    "pushdown peer %s owner tag mismatch (%r != %r)",
                    st.domain, headers["owner_tag"], st.tag,
                )
                self._fail(st, "tag_mismatch")
                return
            # a Table off Flight, IPC bytes off HTTP, or empty for a peer
            # with nothing node-local
            if isinstance(payload, pa.Table):
                table = payload
            elif payload:
                try:
                    table = deserialize_table(payload)
                except pa.ArrowInvalid:
                    logger.warning("bad partial payload from %s", st.domain)
                    self._fail(st, "bad_payload")
                    return
            else:
                table = None
            nbytes = int(headers.get("wire_bytes", 0) or 0)
            st.done = True
            st.transport = headers.get("transport")
            st.elapsed_ms = elapsed * 1000
            st.bytes = nbytes
            st.rows = headers["rows_scanned"]
            self.stats["ok"] += 1
            self.stats["bytes"] += nbytes
            with self.scan._stats_lock:
                self.scan.stats.rows_scanned += headers["rows_scanned"]
                self.scan.stats.scan_errors += headers["scan_errors"]
            if table is not None:
                tables.append(table)
            self._submit_deferred()
            return
        # an error record: the payload is an exception or an HTTP status
        terminal = isinstance(payload, int) and payload in (400, 404, 403, 401)
        logger.warning("pushdown attempt (%s) to %s failed: %s", kind, st.domain, payload)
        if terminal:
            self._fail(st, f"http_{payload}")
        elif not st.retried:
            st.retried = True
            self.stats["retries"] += 1
            self._submit(st, "retry")
        elif st.resolved >= st.issued:
            # nothing left outstanding and the retry is spent
            self._fail(st, "error")
        self._submit_deferred()

    def _fail(self, st: _PeerState, reason: str) -> None:
        st.failed = True
        st.fail_reason = reason
        self.stats["fallback"] += 1

    def _submit_deferred(self) -> None:
        if not self._deferred:
            return
        inflight = sum(
            st.issued - st.resolved for st in self.peers if not st.done and not st.failed
        )
        while self._deferred and inflight < max(1, self.opts.fanout_max_inflight):
            self._submit(self._deferred.pop(0), "initial")
            inflight += 1

    # ---------------------------------------------------------- fallback

    def _fallback_partials(self, failed: list[_PeerState]) -> list[pa.Table]:
        """The central path for exactly the failed peers' slices: their
        staging windows over the bounded fan-in, and the manifest files
        they own, scanned here. The answer for those peers is the central
        data plane's (an unreachable peer's staging window is lost either
        way, and counted)."""
        from parseable_tpu_torch.query.executor import QueryExecutor
        from parseable_tpu_torch.query.provider import StreamScan
        from parseable_tpu_torch.server.cluster import fetch_staging_batches
        from parseable_tpu_torch.utils.arrowutil import adapt_batch, merge_schemas

        parts: list[pa.Table] = []
        ex = QueryExecutor(self.lp)
        fanin: dict = {}
        batches = fetch_staging_batches(
            self.p,
            self.lp.stream,
            time_bounds=self.lp.time_bounds,
            columns=self.lp.needed_columns,
            nodes=[st.node for st in failed],
            stats=fanin,
        )
        self.stats["fallback_fanin_bytes"] += fanin.get("bytes", 0)
        self.scan.add_fanin(fanin)
        if batches:
            schema = merge_schemas([b.schema for b in batches])
            table = pa.Table.from_batches([adapt_batch(schema, b) for b in batches])
            parts.extend(ex.partial_tables(iter([table])))

        tags = tuple(st.tag for st in failed)
        fscan = StreamScan(
            self.p,
            self.lp,
            file_filter=lambda basename: basename.startswith(tags),
            local_staging=False,
            fetch_remote_staging=False,
        )
        tables = fscan.tables()
        try:
            parts.extend(ex.partial_tables(tables))
        finally:
            tables.close()
        with fscan._stats_lock:
            extra = (
                fscan.stats.bytes_scanned,
                fscan.stats.rows_scanned,
                fscan.stats.scan_errors,
            )
        with self.scan._stats_lock:
            self.scan.stats.bytes_scanned += extra[0]
            self.scan.stats.rows_scanned += extra[1]
            self.scan.stats.scan_errors += extra[2]
        return parts


def prepare(
    p: "Parseable", lp: "LogicalPlan", scan: "StreamScan", sql_text: str
) -> DistributedRun | None:
    """The eligibility gate and the scatter's launch. Returns None where the
    query stays central: not a partializable GROUP BY, or no live peer with
    a registered owner tag. Otherwise the local scan is re-scoped (no
    remote staging fan-in: the peers serve their own windows; the manifest
    files of the scattered peers are theirs; no hot stubs: the CPU merge
    cannot read the GPU scan's zero-column stubs) and the peers' requests
    are in flight when this returns."""
    from parseable_tpu_torch.query import partials as PT
    from parseable_tpu_torch.query.executor import QueryExecutor
    from parseable_tpu_torch.server.cluster import live_ingestors

    if not lp.select.group_by:
        return None
    agg, _rewritten, _names = QueryExecutor(lp).build_aggregator()
    if not PT.specs_partializable(agg.specs):
        return None
    peers = [n for n in live_ingestors(p) if n.get("owner_tag")]
    if not peers:
        return None

    body: dict = {"query": sql_text, "fingerprint": PT.plan_fingerprint(lp, "cpu")}
    if lp.time_bounds.low is not None and lp.time_bounds.high is not None:
        body["startTime"] = lp.time_bounds.low.isoformat()
        body["endTime"] = lp.time_bounds.high.isoformat()

    # the querier keeps the files no scattered peer owns; the manifest list
    # memoized for the result-cache key (which covers the FULL set: the
    # merged answer stands for it) is read again under the filter
    scan.use_hot_stubs = False
    scan.fetch_remote_staging = False
    tags = tuple(n["owner_tag"] for n in peers)
    scan.file_filter = lambda basename: not basename.startswith(tags)
    scan._manifest_files = None

    run = DistributedRun(p, lp, scan, peers, body)
    run.start()
    return run
