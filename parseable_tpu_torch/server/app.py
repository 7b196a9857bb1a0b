"""HTTP API server: ingest, query and stream management on one node.

Counterpart of `parseable_tpu/server/app.py` (reference:
src/handlers/http/modal/server.rs route table + middleware.rs auth),
trimmed to the routes of the port's ingest and query path, in the JAX
package's `all` mode:

- `GET /api/v1/liveness`, `/api/v1/readiness` (no auth), `/api/v1/about`;
- `POST /api/v1/ingest` (stream from `X-P-Stream`), `POST /api/v1/logstream/{name}`;
- `POST /api/v1/query` (`query`, `startTime`, `endTime`, `fields`);
- `GET /api/v1/logstream`, `PUT`/`DELETE /api/v1/logstream/{name}`,
  `GET /api/v1/logstream/{name}/schema`.

Status codes and JSON bodies are the JAX package's. Requests authenticate
with Basic auth against the bootstrapped admin (P_USERNAME/P_PASSWORD).
Ingest runs on a worker pool (the native lane parses each body with the
GIL released, sharded over its own pool: `server/ingest_utils.py`),
queries on their own pool, and two background loops move staging into the lake (local sync
every P_LOCAL_SYNC_INTERVAL s, upload every P_STORAGE_UPLOAD_INTERVAL s).

Queries run on the engine of `Options.query_engine`, "gpu" by default:
`ServerState` then probes the card (`utils/devicecheck.py`) and refuses to
start without a working one; there is no CPU fallback. Tests pass
`device="cpu"` to run the GPU engine's plain versions.

`start_server` runs the app on a thread of its own and returns a handle
whose `stop()` drains it (flush, convert, upload); `run_server` serves
until interrupted. Telemetry, audit, tenants, OTel routes, the native
edge, Flight and cluster routes are later slices.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import signal
import threading
from concurrent.futures import ThreadPoolExecutor

import torch
from aiohttp import web

from parseable_tpu_torch import __version__, native
from parseable_tpu_torch.config import Options, StorageOptions, parse_cli
from parseable_tpu_torch.core import Parseable, StreamError, StreamNotFound, validate_stream_name
from parseable_tpu_torch.event.format import LogSource
from parseable_tpu_torch.event.json_format import EventError
from parseable_tpu_torch.ops.enccache import shutdown_enccache
from parseable_tpu_torch.ops.link import shutdown_warmer
from parseable_tpu_torch.query.session import QueryError, QuerySession
from parseable_tpu_torch.query.sql import SqlError
from parseable_tpu_torch.rbac import Action, RbacStore, bootstrap_admin
from parseable_tpu_torch.server.ingest_utils import IngestError, flatten_and_push_logs
from parseable_tpu_torch.utils import devicecheck
from parseable_tpu_torch.utils.timeutil import TimeParseError

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

    `device` is where GPU-engine queries run: None means the card (`cuda`),
    which must answer the device probe or the constructor raises
    `DeviceUnavailable`; "cpu" runs the kernels' plain versions."""

    def __init__(self, p: Parseable, device: torch.device | str | None = None):
        self.p = p
        self.device = self._require_device(p.options.query_engine, device)
        # the native ingest lane's library: built now (g++, first use only),
        # not by the first request; a server that cannot build it does not start
        native.load()
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
            "mode": "All",
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
    return web.json_response({"message": f"created stream {name}"})


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
    r.add_post("/api/v1/ingest", ingest)
    r.add_post("/api/v1/logstream/{name}", post_event)
    r.add_post("/api/v1/query", query)
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
    (recovering orphaned staging files), start the sync loops and serve on
    `opts.address` (port 0 picks a free port) from a thread of its own."""
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
    logger.info(
        "parseable-tpu-torch %s serving on %s:%d (query engine %s on %s, store %s)",
        __version__, host or "0.0.0.0", bound, p.options.query_engine, state.device,
        p.storage.root,
    )
    return server


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
