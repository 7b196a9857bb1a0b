"""Arrow Flight data plane: columnar movement between nodes over gRPC.

Counterpart of `parseable_tpu/server/flight.py` (reference: airplane.rs
do_get, utils/arrow/flight.rs). Flight is the fast tier of the two internal
data-plane calls; ANY decline (a peer with no Flight port in its registry
entry, a channel failure, an auth or ticket mismatch, a stream that dies)
falls back to HTTP + Arrow IPC, which serves the same tables
(`server/cluster.py` and `query/fanout.py` hold the client's ladder).

DoGet tickets are JSON, the JAX package's, so each package's querier reads
the other's ingestors:

- `{"kind": "staging", "stream", "start"?, "end"?, "fields"?}`: the bounded
  staging window, as `GET /api/v1/internal/staging/{s}` serves it (the
  same `staging_window_table`);
- `{"kind": "partial", "stream", "query", "startTime"?, "endTime"?}`: the
  pushed-down partial aggregate, as `POST /api/v1/internal/query/partial/{s}`
  answers it. The peer's accounting (owner tag, rows scanned, scan errors)
  rides as `ptpu.*` schema metadata in place of the `X-P-*` headers; the
  client strips it before the merge.

The Basic cluster credentials of the HTTP tier arrive as a gRPC call header
through a server middleware, and RBAC authorizes QUERY on the ticket's
stream as the HTTP routes do. The JAX module's trace propagation and spans
are not ported.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import threading

import pyarrow as pa
import pyarrow.flight as flight

from parseable_tpu_torch.config import Mode
from parseable_tpu_torch.rbac import Action

logger = logging.getLogger(__name__)

# the partial's accounting as schema metadata (the Flight twin of
# fanout.py's X-P-* headers); the client strips exactly these keys
META_OWNER_TAG = b"ptpu.owner_tag"
META_ROWS = b"ptpu.rows_scanned"
META_ERRORS = b"ptpu.scan_errors"
META_EMPTY = b"ptpu.empty"
_META_KEYS = (META_OWNER_TAG, META_ROWS, META_ERRORS, META_EMPTY)


def strip_flight_meta(table: pa.Table) -> pa.Table:
    """Drop the ptpu.* accounting keys, keeping any metadata the table
    carried before the Flight hop."""
    md = {k: v for k, v in (table.schema.metadata or {}).items() if k not in _META_KEYS}
    return table.replace_schema_metadata(md or None)


def _first_header(headers, name: str):
    """gRPC gives headers as a mapping of lower-case keys to lists."""
    for k, v in headers.items():
        if k.lower() == name:
            if isinstance(v, (list, tuple)):
                return v[0] if v else None
            return v
    return None


def _verify_basic(state, header) -> str | None:
    """The user name of a valid Basic header, else None: the credential
    check of app.py's auth middleware (Flight handlers run on gRPC worker
    threads, so the slow path blocks no event loop)."""
    if not header:
        return None
    if isinstance(header, bytes):
        header = header.decode("latin-1")
    if not header.lower().startswith("basic "):
        return None
    try:
        decoded = base64.b64decode(header.split(" ", 1)[1]).decode()
    except (binascii.Error, UnicodeDecodeError, ValueError):
        return None
    username, _, password = decoded.partition(":")
    user, decided = state.rbac.try_cached_authenticate(username, password)
    if not decided:
        user = state.rbac.authenticate(username, password)
    return username if user is not None else None


class _CallInfo(flight.ServerMiddleware):
    """The caller's identity, captured by the factory for the handler."""

    def __init__(self, username: str):
        self.username = username


class _AuthMiddlewareFactory(flight.ServerMiddlewareFactory):
    """Refuses bad cluster credentials before any handler runs."""

    def __init__(self, state):
        self.state = state

    def start_call(self, info, headers):
        username = _verify_basic(self.state, _first_header(headers, "authorization"))
        if username is None:
            raise flight.FlightUnauthenticatedError("invalid cluster credentials")
        return _CallInfo(username)


class FlightDataServer(flight.FlightServerBase):
    """DoGet server of the two internal data-plane calls, bound to
    `grpc://{host}:{port}` (port 0 picks a free one). Arrow runs the
    handlers on its own thread pool; `start_background()` parks `serve()`
    on one named thread, and `stop()` (called by `ServerState.stop`) shuts
    it down and joins it."""

    def __init__(self, state, host: str, port: int):
        self.state = state
        self._thread: threading.Thread | None = None
        super().__init__(
            location=f"grpc://{host}:{port}",
            middleware={"ptpu-auth": _AuthMiddlewareFactory(state)},
        )

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.serve, name="flight-serve", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        thread, self._thread = self._thread, None
        self.shutdown()
        if thread is not None:
            thread.join(timeout=10)

    def do_get(self, context, ticket):
        call = context.get_middleware("ptpu-auth")
        try:
            req = json.loads(ticket.ticket.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise flight.FlightServerError(f"bad ticket: {e}") from e
        kind = req.get("kind")
        stream = str(req.get("stream") or "")
        if call is not None and not self.state.rbac.authorize(call.username, Action.QUERY, stream):
            raise flight.FlightUnauthorizedError(f"user {call.username!r} may not query {stream!r}")
        if kind == "staging":
            table = self._staging_table(req, stream)
        elif kind == "partial":
            table = self._partial_table(req, stream)
        else:
            raise flight.FlightServerError(f"unknown ticket kind {kind!r}")
        # RecordBatchStream serializes straight from the table's buffers
        return flight.RecordBatchStream(table)

    def _staging_table(self, req: dict, name: str) -> pa.Table:
        """The bounded staging window, from the HTTP route's helper. An
        empty window or an unknown stream is a table of no columns (the
        HTTP tier's 204)."""
        from parseable_tpu_torch.server.app import staging_window_table
        from parseable_tpu_torch.utils.timeutil import TimeParseError, parse_rfc3339

        stream = self.state.p.streams.get(name)
        if stream is None:
            return pa.table({})
        try:
            start = parse_rfc3339(req["start"]) if req.get("start") else None
            end = parse_rfc3339(req["end"]) if req.get("end") else None
        except TimeParseError as e:
            raise flight.FlightServerError(f"bad time bound: {e}") from e
        fields = set(req["fields"]) if req.get("fields") is not None else None
        table = staging_window_table(stream, start, end, fields)
        return table if table is not None else pa.table({})

    def _partial_table(self, req: dict, name: str) -> pa.Table:
        """The pushed-down partial aggregate. Any error surfaces as a Flight
        error, which the client takes as a decline and retries over HTTP;
        HTTP then tells a final refusal (400) from a retryable failure."""
        from parseable_tpu_torch.query import fanout as FO

        sql = req.get("query")
        if not sql:
            raise flight.FlightServerError("missing 'query' in partial ticket")
        try:
            out = FO.execute_local_partial_table(
                self.state.p, name, sql, req.get("startTime"), req.get("endTime")
            )
        except FO.UnsupportedPartial as e:
            raise flight.FlightServerError(f"unsupported partial: {e}") from e
        except flight.FlightError:
            raise
        except Exception as e:
            logger.exception("flight partial pushdown failed")
            raise flight.FlightServerError(str(e)) from e
        meta = {"owner_tag": self.state.p.owner_tag, "rows_scanned": 0, "scan_errors": 0}
        table = None
        if out is not None:
            table, meta = out
        md = {
            META_OWNER_TAG: str(meta["owner_tag"]).encode(),
            META_ROWS: str(meta["rows_scanned"]).encode(),
            META_ERRORS: str(meta["scan_errors"]).encode(),
        }
        if table is None:
            # an empty slice or an unknown stream: HTTP's 204 with the
            # accounting headers becomes an empty table with the marker
            md[META_EMPTY] = b"1"
            table = pa.table({})
        full = dict(table.schema.metadata or {})
        full.update(md)
        return table.replace_schema_metadata(full)


def maybe_start_flight(state) -> FlightDataServer | None:
    """Start the Flight data plane of a serving process where configured:
    `P_FLIGHT_PORT` > 0 on an ingest-capable node (the two calls serve
    node-local data, as the HTTP internal routes do, which only all and
    ingest nodes have). Returns None otherwise, and zeroes the advertised
    port so `register_node` never publishes a plane this node does not
    serve: the registry entry is the client's gate to the Flight tier."""
    opts = state.p.options
    port = opts.flight_port
    if port <= 0:
        return None
    if opts.mode not in (Mode.ALL, Mode.INGEST):
        opts.flight_port = 0
        return None
    host, _, _ = opts.address.rpartition(":")
    host = host or "0.0.0.0"
    try:
        srv = FlightDataServer(state, host, port)
        srv.start_background()
    except Exception:
        logger.exception("flight data plane failed to start on port %d; staying on HTTP", port)
        opts.flight_port = 0
        return None
    opts.flight_port = srv.port
    logger.info("flight data plane serving on grpc://%s:%d", host, srv.port)
    return srv
