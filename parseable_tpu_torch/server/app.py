"""HTTP API server: ingest, query and stream management, in any node mode.

Counterpart of `parseable_tpu/server/app.py` (reference:
src/handlers/http/modal/server.rs route table + middleware.rs auth),
trimmed to the routes of the port's ingest, query and cluster paths. The
route table follows the node's mode (`P_MODE`, JAX app.py:2283-2296):

- every mode: `GET /api/v1/liveness`, `/api/v1/readiness` (no auth),
  `/api/v1/about`; `GET /api/v1/logstream`, `PUT`/`DELETE
  /api/v1/logstream/{name}`, `GET /api/v1/logstream/{name}/schema`;
- `all` and `ingest`: `POST /api/v1/ingest` (stream from `X-P-Stream`),
  `POST /api/v1/logstream/{name}`, and the intra-cluster data plane:
  `GET /api/v1/internal/staging/{name}` (this node's bounded staging
  window as Arrow IPC) and `POST /api/v1/internal/query/partial/{name}`
  (a pushed-down GROUP BY over this node's slice, `query/fanout.py`);
- `all` and `query`: `POST /api/v1/query` (`query`, `startTime`,
  `endTime`, `fields`).

Status codes and JSON bodies are the JAX package's. Requests authenticate
with Basic auth against the bootstrapped admin (P_USERNAME/P_PASSWORD).
Ingest runs on a worker pool (the native lane parses each body with the
GIL released, sharded over its own pool: `server/ingest_utils.py`),
queries on their own pool, and on `all` and `ingest` nodes two background
loops move staging into the lake (local sync every P_LOCAL_SYNC_INTERVAL s,
upload every P_STORAGE_UPLOAD_INTERVAL s).

Queries run on the engine of `Options.query_engine`, "gpu" by default. A
node that answers queries (`all`, `query`) with that engine probes the card
(`utils/devicecheck.py`) and refuses to start without a working one; there
is no CPU fallback. An `ingest` node never touches the card: its partial
route runs the CPU engine, as the JAX package's does. Tests pass
`device="cpu"` to run the GPU engine's plain versions.

At start (`start_server`) an ingest-capable node with `P_FLIGHT_PORT` > 0
starts the Arrow Flight data plane (`server/flight.py`), and then every
node registers itself in the node registry (`Parseable.register_node`). A
query node fans stream creation and deletion out to the live ingestors.
`start_server` runs the app on a thread of its own and returns a handle
whose `stop()` drains it (flush, convert, upload); `run_server` serves
until interrupted. Telemetry, audit, tenants, OTel routes, the native
edge, the cluster metrics and trace routes are later slices.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import signal
import threading
from concurrent.futures import ThreadPoolExecutor

import pyarrow as pa
import pyarrow.compute as pc
import torch
from aiohttp import web

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY, __version__, native
from parseable_tpu_torch.config import Mode, Options, StorageOptions, parse_cli
from parseable_tpu_torch.core import Parseable, StreamError, StreamNotFound, validate_stream_name
from parseable_tpu_torch.event.format import LogSource
from parseable_tpu_torch.event.json_format import EventError
from parseable_tpu_torch.ops.enccache import shutdown_enccache
from parseable_tpu_torch.ops.link import shutdown_warmer
from parseable_tpu_torch.query.session import QueryError, QuerySession
from parseable_tpu_torch.query.sql import SqlError
from parseable_tpu_torch.rbac import Action, RbacStore, bootstrap_admin
from parseable_tpu_torch.server import cluster
from parseable_tpu_torch.server.ingest_utils import IngestError, flatten_and_push_logs
from parseable_tpu_torch.utils import devicecheck
from parseable_tpu_torch.utils.arrowutil import adapt_batch, merge_schemas
from parseable_tpu_torch.utils.timeutil import TimeParseError, parse_rfc3339

logger = logging.getLogger(__name__)

STREAM_HEADER = "X-P-Stream"
LOG_SOURCE_HEADER = "X-P-Log-Source"
CUSTOM_FIELD_PREFIX = "x-p-meta-"
TIME_PARTITION_HEADER = "X-P-Time-Partition"
CUSTOM_PARTITION_HEADER = "X-P-Custom-Partition"
TELEMETRY_TYPE_HEADER = "X-P-Telemetry-Type"

_BODY_TOO_LARGE = {"error": "payload too large"}


class ServerState:
    """Wires Parseable + RBAC + workers + sync loops for one server process.

    `device` is where GPU-engine queries run on a node that answers
    queries (`all`, `query`): None means the card (`cuda`), which must
    answer the device probe or the constructor raises `DeviceUnavailable`;
    "cpu" runs the kernels' plain versions. An `ingest` node has no device."""

    def __init__(self, p: Parseable, device: torch.device | str | None = None):
        self.p = p
        mode = p.options.mode
        self.device = (
            self._require_device(p.options.query_engine, device) if mode != Mode.INGEST else None
        )
        if mode != Mode.QUERY:
            # the native ingest lane's library: built now (g++, first use
            # only), not by the first request; an ingesting server that
            # cannot build it does not start
            native.load()
        # the Arrow Flight data plane, when this node serves one
        self.flight = None
        self.rbac = RbacStore()
        bootstrap_admin(self.rbac, p.options.username, p.options.password)
        self.workers = ThreadPoolExecutor(max_workers=8, thread_name_prefix="ingest")
        # queries on a pool of their own: scans must not starve ingest
        self.query_workers = ThreadPoolExecutor(
            max_workers=max(1, p.options.query_workers), thread_name_prefix="query"
        )
        self.shutting_down = False
        self._sync_stop = threading.Event()
        self._sync_threads: list[threading.Thread] = []

    @staticmethod
    def _require_device(engine: str, device) -> torch.device | None:
        if engine != "gpu":
            return None
        device = torch.device(device if device is not None else "cuda")
        if device.type == "cuda":
            report = devicecheck.probe(device)
            if not (report.get("available") and report.get("healthy")):
                raise devicecheck.DeviceUnavailable(
                    f"query engine 'gpu' needs a working CUDA device; probe: {report}"
                )
        return devicecheck.require_device(device)

    def start_sync_loops(self) -> None:
        """The local-sync tick (flush + compaction, each parquet uploaded as
        it lands: `Parseable.sync_cycle`) and the object-sync tick (upload
        of whatever is left staged) (reference: src/sync.rs)."""

        def loop(interval: int, fn, name: str) -> None:
            def run() -> None:
                while not self._sync_stop.wait(interval):
                    try:
                        fn()
                    except Exception:
                        # per-tick isolation: the loop itself never dies
                        logger.exception("%s tick failed", name)

            t = threading.Thread(target=run, name=name, daemon=True)
            t.start()
            self._sync_threads.append(t)

        opts = self.p.options
        if opts.mode == Mode.QUERY:
            return  # a query node stages nothing
        loop(opts.local_sync_interval_secs, self.p.sync_cycle, "local-sync")
        loop(opts.upload_interval_secs, self.p.sync_all_streams, "object-sync")

    def stop(self) -> None:
        """Stop the loops (an in-flight tick finishes), then flush, convert
        and upload everything staged (`Parseable.shutdown`), and stop the
        encoded-block cache's writer. Idempotent."""
        if self.shutting_down:
            return
        self.shutting_down = True
        self._sync_stop.set()
        for t in self._sync_threads:
            t.join()
        self._sync_threads.clear()
        if self.flight is not None:
            self.flight.stop()
            self.flight = None
        self.workers.shutdown(wait=True)
        self.query_workers.shutdown(wait=True)
        self.p.shutdown()
        # the device warmer (queued warms run first; one may write behind
        # into the encoded-block cache, so it stops before that cache's
        # writer), the encoded-block cache's write-behind thread and the
        # native parse pool (it drains queued shard jobs before joining,
        # and restarts lazily if anything parses after the stop): every
        # thread the server starts has a deterministic stop
        shutdown_warmer()
        shutdown_enccache()
        native.shutdown_parse_pool()
        cluster.shutdown_cluster_pool()
        cluster.shutdown_conn_pool()
        cluster.shutdown_flight_pool()


STATE = web.AppKey("state", ServerState)

# ---------------------------------------------------------------- middleware


def _unauthorized(reason: str = "Unauthorized") -> web.Response:
    return web.json_response({"error": reason}, status=401)


@web.middleware
async def auth_middleware(request: web.Request, handler):
    """Basic auth on every route but the health probes (middleware.rs)."""
    state: ServerState = request.app[STATE]
    if request.path in ("/api/v1/liveness", "/api/v1/readiness") or request.method == "OPTIONS":
        return await handler(request)
    auth = request.headers.get("Authorization", "")
    if not auth.startswith("Basic "):
        return _unauthorized("missing credentials")
    try:
        user, _, pw = base64.b64decode(auth[6:]).decode().partition(":")
    except ValueError:
        return _unauthorized("invalid basic auth")
    # cache hits answer here; a miss needs scrypt (~10^2 ms by design), which
    # runs on a worker so it does not block the event loop
    authed, decided = state.rbac.try_cached_authenticate(user, pw)
    if not decided:
        authed = await asyncio.get_running_loop().run_in_executor(
            state.workers, state.rbac.authenticate, user, pw
        )
    if authed is None:
        return _unauthorized()
    request["username"] = user
    return await handler(request)


def require(action: Action, resource_param: str | None = None):
    """RBAC guard (reference: RouteExt::authorize*)."""

    def deco(fn):
        async def wrapped(request: web.Request):
            state: ServerState = request.app[STATE]
            resource = (
                request.match_info.get(resource_param)
                if resource_param
                else request.headers.get(STREAM_HEADER)
            )
            if not state.rbac.authorize(request["username"], action, resource):
                return web.json_response({"error": "Forbidden"}, status=403)
            return await fn(request)

        return wrapped

    return deco


def _run(state: ServerState, fn, *args):
    return asyncio.get_running_loop().run_in_executor(state.workers, fn, *args)


# ------------------------------------------------------------------ handlers


async def liveness(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    return web.Response(status=503 if state.shutting_down else 200)


async def readiness(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    try:
        await asyncio.get_running_loop().run_in_executor(None, state.p.storage.list_dirs, "")
        return web.Response(status=200)
    except Exception:
        return web.Response(status=503)


@require(Action.GET_ABOUT)
async def about(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    return web.json_response(
        {
            "version": __version__,
            "uiVersion": "none",
            "commit": "",
            "deploymentId": state.p.node_id,
            "mode": state.p.options.mode.to_str(),
            "staging": str(state.p.options.local_staging_path),
            "store": {"type": state.p.storage.name, "path": str(state.p.storage.root)},
            "queryEngine": state.p.options.query_engine,
            "device": str(state.device) if state.device is not None else None,
            "license": "AGPL-3.0",
        }
    )


def _custom_fields(request: web.Request) -> dict[str, str]:
    return {
        k[len(CUSTOM_FIELD_PREFIX) :]: v
        for k, v in request.headers.items()
        if k.lower().startswith(CUSTOM_FIELD_PREFIX)
    }


@require(Action.INGEST)
async def ingest(request: web.Request) -> web.Response:
    """POST /api/v1/ingest (reference: ingest.rs:69)."""
    stream_name = request.headers.get(STREAM_HEADER)
    if not stream_name:
        return web.json_response({"error": f"missing {STREAM_HEADER} header"}, status=400)
    log_source = LogSource.from_str(request.headers.get(LOG_SOURCE_HEADER, "json"))
    if log_source in (LogSource.OTEL_LOGS, LogSource.OTEL_METRICS, LogSource.OTEL_TRACES):
        return web.json_response(
            {"error": "use /v1/logs, /v1/metrics or /v1/traces for OTel data"}, status=400
        )
    return await _do_ingest(request, stream_name, log_source)


async def post_event(request: web.Request) -> web.Response:
    """POST /api/v1/logstream/{name} (reference: ingest.rs:393)."""
    state: ServerState = request.app[STATE]
    stream_name = request.match_info["name"]
    if not state.rbac.authorize(request["username"], Action.INGEST, stream_name):
        return web.json_response({"error": "Forbidden"}, status=403)
    log_source = LogSource.from_str(request.headers.get(LOG_SOURCE_HEADER, "json"))
    return await _do_ingest(request, stream_name, log_source)


async def _read_body(request: web.Request) -> bytes | None:
    """Body read under the app's `client_max_size`; None past it."""
    try:
        return await request.read()
    except web.HTTPRequestEntityTooLarge:
        return None


async def _do_ingest(request: web.Request, stream_name: str, log_source: LogSource) -> web.Response:
    state: ServerState = request.app[STATE]
    body = await _read_body(request)
    if body is None or len(body) > state.p.options.max_event_payload_bytes:
        return web.json_response(_BODY_TOO_LARGE, status=413)
    custom_fields = _custom_fields(request)
    log_source_name = request.headers.get(LOG_SOURCE_HEADER, "json")

    def work() -> int:
        state.p.create_stream_if_not_exists(stream_name, log_source=log_source)
        return flatten_and_push_logs(
            state.p,
            stream_name,
            None,
            log_source,
            custom_fields,
            origin_size=len(body),
            log_source_name=log_source_name,
            raw_body=body,
        )

    try:
        count = await _run(state, work)
    except (IngestError, StreamError, EventError) as e:
        return web.json_response({"error": str(e)}, status=400)
    return web.json_response({"message": f"ingested {count} records"}, status=200)


@require(Action.QUERY)
async def query(request: web.Request) -> web.Response:
    """POST /api/v1/query (reference: handlers/http/query.rs:157)."""
    state: ServerState = request.app[STATE]
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return web.json_response({"error": "invalid JSON body"}, status=400)
    sql = body.get("query")
    if not sql:
        return web.json_response({"error": "missing 'query'"}, status=400)
    start, end = body.get("startTime"), body.get("endTime")
    send_fields = bool(body.get("fields", False))

    from parseable_tpu_torch.query.executor import MemoryLimitExceeded, QueryTimeout

    def work():
        return QuerySession(state.p, device=state.device).query(sql, start, end)

    try:
        result = await asyncio.get_running_loop().run_in_executor(state.query_workers, work)
    except QueryTimeout as e:
        return web.json_response({"error": str(e)}, status=504)
    except MemoryLimitExceeded as e:
        return web.json_response({"error": str(e)}, status=413)
    except (QueryError, SqlError, TimeParseError) as e:
        return web.json_response({"error": str(e)}, status=400)
    except Exception as e:
        logger.exception("query failed")
        return web.json_response({"error": str(e)}, status=500)

    rows = result.to_json_rows()
    if send_fields:
        return web.json_response({"fields": result.fields, "records": rows, "stats": result.stats})
    return web.json_response(rows)


# ----- logstream management (reference: handlers/http/logstream.rs) --------


@require(Action.LIST_STREAM)
async def list_streams(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    await _run(state, state.p.load_streams_from_storage)
    return web.json_response([{"name": n} for n in state.p.streams.list_names()])


@require(Action.CREATE_STREAM, "name")
async def put_stream(request: web.Request) -> web.Response:
    """PUT /api/v1/logstream/{name}: create a stream (time/custom partition
    and telemetry type from the headers). Stream updates and static
    schemas are later slices."""
    state: ServerState = request.app[STATE]
    name = request.match_info["name"]
    try:
        validate_stream_name(name)
        if state.p.streams.contains(name):
            return web.json_response({"error": f"stream {name} already exists"}, status=400)
        await _run(
            state,
            lambda: state.p.create_stream_if_not_exists(
                name,
                time_partition=request.headers.get(TIME_PARTITION_HEADER),
                custom_partition=request.headers.get(CUSTOM_PARTITION_HEADER),
                telemetry_type=request.headers.get(TELEMETRY_TYPE_HEADER, "logs"),
            ),
        )
    except StreamError as e:
        return web.json_response({"error": str(e)}, status=400)
    fanout_to_ingestors(state, "PUT", f"/api/v1/logstream/{name}", headers=_xp_headers(request))
    return web.json_response({"message": f"created stream {name}"})


def _xp_headers(request: web.Request) -> dict[str, str]:
    return {k: v for k, v in request.headers.items() if k.lower().startswith("x-p-")}


@require(Action.DELETE_STREAM, "name")
async def delete_stream(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    name = request.match_info["name"]
    if not state.p.streams.contains(name):
        return web.json_response({"error": f"stream {name} not found"}, status=404)

    def _delete() -> None:
        state.p.streams.delete(name)
        state.p.metastore.delete_stream(name)

    await _run(state, _delete)
    fanout_to_ingestors(state, "DELETE", f"/api/v1/logstream/{name}")
    return web.json_response({"message": f"deleted stream {name}"})


@require(Action.GET_SCHEMA, "name")
async def get_schema(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    name = request.match_info["name"]
    try:
        stream = state.p.get_stream(name)
    except StreamNotFound:
        return web.json_response({"error": f"stream {name} not found"}, status=404)
    fields = [
        {"name": f.name, "data_type": str(f.type), "nullable": f.nullable}
        for f in stream.metadata.schema.values()
    ]
    return web.json_response({"fields": fields})


# ----- intra-cluster data plane ---------------------------------------------


def staging_window_table(stream, start, end, fields) -> pa.Table | None:
    """This node's staging window as ONE table, bounded to [start, end) and
    projected to `fields` (the timestamp column always rides along so the
    querier can filter again). The HTTP staging route and the Flight
    `staging` ticket (`server/flight.py`) both serve it. None when the
    window is empty.

    The window is the finished `.arrows` and the staged parquet no upload
    has claimed (not yet committed, so the querier's manifest scan cannot
    count it too), read under the stream lock in one step: a conversion
    between the two reads would otherwise hand a row over twice."""
    with stream.lock:
        batches = stream.staging_batches()
        batches.extend(stream.unclaimed_parquet_batches())
    if not batches:
        return None
    schema = merge_schemas([b.schema for b in batches])
    table = pa.Table.from_batches([adapt_batch(schema, b) for b in batches])
    if (start is not None or end is not None) and DEFAULT_TIMESTAMP_KEY in table.column_names:
        col = table.column(DEFAULT_TIMESTAMP_KEY)
        mask = None
        if start is not None:
            mask = pc.greater_equal(col, pa.scalar(start.replace(tzinfo=None), type=col.type))
        if end is not None:
            m2 = pc.less(col, pa.scalar(end.replace(tzinfo=None), type=col.type))
            mask = m2 if mask is None else pc.and_(mask, m2)
        table = table.filter(mask)
    if fields is not None:
        table = table.select(
            [c for c in table.column_names if c in fields or c == DEFAULT_TIMESTAMP_KEY]
        )
    if table.num_rows == 0:
        return None
    return table


@require(Action.QUERY, "name")
async def internal_staging(request: web.Request) -> web.Response:
    """GET /api/v1/internal/staging/{name}: this node's staging window as
    Arrow IPC (reference: airplane.rs:155-184, over HTTP). Optional bounds:
    `start`/`end` (RFC 3339) keep rows in [start, end) of the event
    timestamp, and `fields` (comma-separated) projects the columns; without
    them the whole window ships. 204 when there is nothing to send."""
    state: ServerState = request.app[STATE]
    name = request.match_info["name"]
    stream = state.p.streams.get(name)
    if stream is None:
        return web.Response(status=204)
    try:
        start = parse_rfc3339(request.query["start"]) if "start" in request.query else None
        end = parse_rfc3339(request.query["end"]) if "end" in request.query else None
    except TimeParseError as e:
        return web.json_response({"error": f"bad time bound: {e}"}, status=400)
    fields = None
    if "fields" in request.query:
        fields = {f for f in request.query["fields"].split(",") if f}

    def work() -> bytes:
        from parseable_tpu_torch.query.fanout import serialize_table

        table = staging_window_table(stream, start, end, fields)
        return b"" if table is None else serialize_table(table)

    data = await _run(state, work)
    if not data:
        return web.Response(status=204)
    return web.Response(body=data, content_type="application/vnd.apache.arrow.stream")


@require(Action.QUERY, "name")
async def internal_query_partial(request: web.Request) -> web.Response:
    """POST /api/v1/internal/query/partial/{name}: run a pushed-down GROUP
    BY over this node's slice (its staging window and the manifest files
    it owns) and answer one combined partial table as Arrow IPC
    (`query/fanout.py`). 204 = an empty slice; 400 = a plan the partial
    protocol cannot express (the querier serves this node's slice
    centrally). The headers carry the scan's accounting and this node's
    owner tag, which the querier checks against the registry."""
    from parseable_tpu_torch.query import fanout as FO

    state: ServerState = request.app[STATE]
    name = request.match_info["name"]
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return web.json_response({"error": "invalid JSON body"}, status=400)
    sql = body.get("query")
    if not sql:
        return web.json_response({"error": "missing 'query'"}, status=400)
    start, end = body.get("startTime"), body.get("endTime")

    def work():
        return FO.execute_local_partial(state.p, name, sql, start, end)

    try:
        out = await asyncio.get_running_loop().run_in_executor(state.query_workers, work)
    except (FO.UnsupportedPartial, SqlError, QueryError, TimeParseError) as e:
        return web.json_response({"error": str(e)}, status=400)
    except Exception as e:
        logger.exception("partial pushdown failed")
        return web.json_response({"error": str(e)}, status=500)
    headers = {FO.H_TAG: state.p.owner_tag}
    if out is None:
        return web.Response(status=204, headers=headers)
    payload, meta = out
    headers[FO.H_ROWS] = str(meta["rows_scanned"])
    headers[FO.H_ERRORS] = str(meta["scan_errors"])
    if not payload:
        return web.Response(status=204, headers=headers)
    return web.Response(
        body=payload, content_type="application/vnd.apache.arrow.stream", headers=headers
    )


def fanout_to_ingestors(state: ServerState, method: str, path: str, headers=None) -> None:
    """Send a query node's stream mutation on to the live ingestors
    (reference: cluster/mod.rs:391-840), in the background: the metastore
    holds the durable state, the fan-out refreshes the peers' streams."""
    if state.p.options.mode != Mode.QUERY:
        return

    def _fanout() -> None:
        # the future is dropped, so the worker logs its own errors
        try:
            failed = cluster.sync_with_ingestors(state.p, method, path, headers=headers)
            if failed:
                logger.warning("peer fan-out %s %s failed for: %s", method, path, failed)
        except Exception:
            logger.exception("peer fan-out %s %s failed", method, path)

    state.workers.submit(_fanout)


# -------------------------------------------------------------------- app


def build_app(state: ServerState) -> web.Application:
    # bodies past the ingest payload cap are refused while being read
    app = web.Application(
        middlewares=[auth_middleware], client_max_size=state.p.options.max_event_payload_bytes
    )
    app[STATE] = state
    r = app.router
    r.add_get("/api/v1/liveness", liveness)
    r.add_get("/api/v1/readiness", readiness)
    r.add_get("/api/v1/about", about)
    mode = state.p.options.mode
    if mode in (Mode.ALL, Mode.INGEST):
        r.add_post("/api/v1/ingest", ingest)
        r.add_post("/api/v1/logstream/{name}", post_event)
        r.add_get("/api/v1/internal/staging/{name}", internal_staging)
        r.add_post("/api/v1/internal/query/partial/{name}", internal_query_partial)
    if mode in (Mode.ALL, Mode.QUERY):
        r.add_post("/api/v1/query", query)
    # stream management on every mode (ingestors take synced definitions)
    r.add_get("/api/v1/logstream", list_streams)
    r.add_put("/api/v1/logstream/{name}", put_stream)
    r.add_delete("/api/v1/logstream/{name}", delete_stream)
    r.add_get("/api/v1/logstream/{name}/schema", get_schema)
    return app


class RunningServer:
    """A server started by `start_server`: its state, the bound port and the
    thread running its event loop."""

    def __init__(self, state: ServerState, loop: asyncio.AbstractEventLoop, runner, port: int):
        self.state = state
        self.port = port
        self._loop = loop
        self._runner = runner
        self._thread: threading.Thread | None = threading.Thread(
            target=loop.run_forever, name="http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Close the listener, finish in-flight requests, then drain staging
        into the lake (`ServerState.stop`). Idempotent."""
        if self._thread is None:
            return
        asyncio.run_coroutine_threadsafe(self._runner.cleanup(), self._loop).result()
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join()
        self._thread = None
        self._loop.close()
        self.state.stop()


def start_server(
    opts: Options | None = None,
    storage: StorageOptions | None = None,
    device: torch.device | str | None = None,
) -> RunningServer:
    """Boot a server in this process: bootstrap the streams in storage
    (recovering orphaned staging files), start the sync loops, serve on
    `opts.address` (port 0 picks a free port) from a thread of its own, and
    once the port is bound start the Flight data plane (where configured)
    and register the node with its reachable endpoint."""
    p = Parseable(opts, storage)
    state = ServerState(p, device=device)
    p.load_streams_from_storage()
    state.start_sync_loops()
    host, _, port = p.options.address.rpartition(":")
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(build_app(state))

    async def serve() -> int:
        await runner.setup()
        site = web.TCPSite(runner, host or "0.0.0.0", int(port or 8000))
        await site.start()
        return runner.addresses[0][1]

    try:
        bound = loop.run_until_complete(serve())
    except BaseException:
        loop.run_until_complete(runner.cleanup())
        loop.close()
        state.stop()
        raise
    server = RunningServer(state, loop, runner, bound)
    try:
        # Flight before registration: register_node advertises its port,
        # and a failed start zeroes it, so no peer dials a missing plane
        state.flight = _start_flight(state)
        reg_host = "127.0.0.1" if host in ("", "0.0.0.0") else host
        p.register_node(f"{reg_host}:{bound}")
    except BaseException:
        server.stop()
        raise
    logger.info(
        "parseable-tpu-torch %s serving in %s mode on %s:%d (query engine %s on %s, store %s)",
        __version__, p.options.mode.value, host or "0.0.0.0", bound, p.options.query_engine,
        state.device, p.storage.root,
    )
    return server


def _start_flight(state: ServerState):
    """The Flight data plane where `P_FLIGHT_PORT` asks for it; a pyarrow
    built without Flight keeps the node on HTTP."""
    if state.p.options.flight_port <= 0:
        return None
    try:
        from parseable_tpu_torch.server.flight import maybe_start_flight
    except ImportError:
        logger.warning(
            "P_FLIGHT_PORT=%d set but pyarrow.flight is unavailable; staying on HTTP",
            state.p.options.flight_port,
        )
        state.p.options.flight_port = 0
        return None
    return maybe_start_flight(state)


def run_server(opts: Options | None = None, storage: StorageOptions | None = None) -> None:
    """Serve until SIGINT or SIGTERM, then drain staging into the lake."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    server = start_server(opts, storage)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    server.stop()


def main(argv: list[str] | None = None) -> None:
    opts, storage = parse_cli(argv)
    run_server(opts, storage)
