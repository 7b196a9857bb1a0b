"""The port's cluster data plane against the JAX package's, on the CPU.

Each test boots an in-process cluster: ingest-mode servers on port 0 (the
port's through `start_server`, the JAX package's app on a thread), one
LocalFS store under `tmp_path` that every node shares, and a query-mode
`Parseable` that scatters to them (`query/fanout.py`) or pulls their
staging windows (`server/cluster.py`). The port's querier runs its GPU
engine with `device="cpu"` (the kernels' plain versions) on the central
path; a pushed-down aggregate merges on the CPU engine in both packages.

The JAX ingestors take their rows over HTTP through their Python lane: the
JAX package's native loader is patched to find nothing, so this file never
builds or loads that library (ROADMAP §3's xdist race).

Tolerances: counts and keys exact; pushdown against the port's central
path (f32 sums on the GPU engine) rel 2e-4, abs 1e-6; the port's pushdown
against the JAX package's, both f64 on the CPU engine, rel 1e-9;
percentiles between engines rel 0.06 (PERF.md §2). Fan-out timeouts are
1-3 s, so no test waits out the 10 s default.
"""

import asyncio
import base64
import json
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest
from aiohttp import web

import parseable_tpu.native as jax_native
from parseable_tpu.config import Mode as JaxMode
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.config import StorageOptions as JaxStorageOptions
from parseable_tpu.core import Parseable as JaxParseable
from parseable_tpu.query import executor as jax_executor
from parseable_tpu.query import partials as jax_partials
from parseable_tpu.query import planner as jax_planner
from parseable_tpu.query import sql as jax_sql
from parseable_tpu.query.session import QuerySession as JaxQuerySession
from parseable_tpu.server import app as jax_app
from parseable_tpu.server import cluster as jax_cluster
from parseable_tpu_torch.config import Mode, Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.ops import cuda_lib
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.ops.link import shutdown_warmer
from parseable_tpu_torch.query import executor as port_executor
from parseable_tpu_torch.query import fanout as FO
from parseable_tpu_torch.query import partials as port_partials
from parseable_tpu_torch.query import planner as port_planner
from parseable_tpu_torch.query import sql as port_sql
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.server import app as port_app
from parseable_tpu_torch.server import cluster as C
from parseable_tpu_torch.server.app import start_server
from parseable_tpu_torch.utils import devicecheck

STREAM = "dist"
AUTH = "Basic " + base64.b64encode(b"admin:admin").decode()
REL, ABS = 2e-4, 1e-6
F64_REL = 1e-9
PCT_REL = 0.06
ROWS = 240  # per ingestor
# a healthy peer answers 240 rows in tens of ms; the timeout leaves room
# for a loaded test machine
FAST = {"fanout_timeout_ms": 3000, "fanout_hedge_ms": 0}

# pushed down: partializable GROUP BYs
PUSHED = {
    "status": (
        "SELECT status, count(*) c, sum(bytes) b, avg(lat) a, min(lat) mn, max(bytes) mx, "
        "stddev(lat) sd FROM dist GROUP BY status ORDER BY status"
    ),
    "host_status": (
        "SELECT host, status, count(*) c, sum(lat) s, var(lat) v FROM dist "
        "WHERE bytes >= 1000 GROUP BY host, status ORDER BY host, status"
    ),
}
# central: no partial form, or no GROUP BY
CENTRAL = {
    "percentile": (
        "SELECT status, approx_percentile_cont(lat, 0.5) p50, count(*) c FROM dist "
        "GROUP BY status ORDER BY status"
    ),
    "distinct": "SELECT status, count(distinct host) d FROM dist GROUP BY status ORDER BY status",
    "no_group_by": "SELECT count(*) c, sum(bytes) b, max(lat) mx FROM dist WHERE status >= 400",
    "select": "SELECT host, status, bytes FROM dist WHERE status = 500 ORDER BY bytes, host",
}


@pytest.fixture(autouse=True)
def _fresh_cluster_state(monkeypatch):
    """Module-level pools and dead-node memories outlive a test: reset
    them (as tests/test_fanout.py does). The JAX ingestors run their
    Python lane, and no block of the port's GPU engine is taken from an
    earlier test's hot set or encoded-block cache."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "flatten_columnar", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "flatten_ndjson", lambda *a, **k: None)
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    get_hotset().clear()
    for mod in (C, jax_cluster):
        mod._dead_nodes.clear()
    yield
    for mod in (C, jax_cluster):
        mod._dead_nodes.clear()
        mod.shutdown_cluster_pool()
        mod.shutdown_conn_pool()
        mod.shutdown_flight_pool()
    shutdown_warmer()
    get_hotset().clear()


# ------------------------------------------------------------------ rows


def make_rows(seed: int, n: int = ROWS) -> list[dict]:
    rng = np.random.default_rng(seed)
    hosts = np.array([f"h{i}" for i in range(6)])
    statuses = np.array([200, 200, 404, 500])
    return [
        {"host": str(h), "status": int(s), "bytes": int(b), "lat": float(x)}
        for h, s, b, x in zip(
            hosts[rng.integers(0, len(hosts), n)],
            statuses[rng.integers(0, len(statuses), n)],
            rng.integers(100, 5000, n),
            rng.random(n) * 500,
        )
    ]


def http(port: int, method: str, path: str, body: bytes | None = None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=body,
        method=method,
        headers={"Authorization": AUTH, "Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def ingest(port: int, rows: list[dict]) -> None:
    status, body, _ = http(port, "POST", "/api/v1/ingest", json.dumps(rows).encode(), {"X-P-Stream": STREAM})
    assert status == 200, body


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- nodes


class PortNode:
    """A port server in ingest mode (or another mode), started through the
    normal entry point on port 0."""

    def __init__(self, base, name: str, mode: Mode = Mode.INGEST, flight=False, device=None, **opts):
        o = Options()
        o.mode = mode
        o.address = "127.0.0.1:0"
        o.local_staging_path = base / f"staging-{name}"
        o.local_sync_interval_secs = 3600  # no tick during a test: syncs are explicit
        o.upload_interval_secs = 3600
        o.query_result_cache_bytes = 0
        o.flight_port = free_port() if flight else 0
        for k, v in opts.items():
            setattr(o, k, v)
        self.server = start_server(o, StorageOptions(root=base / "store"), device=device)
        self.p = self.server.state.p
        self.port = self.server.port

    def stop(self) -> None:
        self.server.stop()


def _serve(app) -> tuple[int, callable]:
    """Run an aiohttp app on a loop of its own thread; returns its port and
    a stop function."""
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = runner.addresses[0][1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop() -> None:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()

    return port, stop


class JaxNode:
    """The JAX package's server in ingest mode, registered like its own
    `run_server` does."""

    def __init__(self, base, name: str, flight=False):
        o = JaxOptions()
        o.mode = JaxMode.INGEST
        o.local_staging_path = base / f"staging-{name}"
        o.query_engine = "cpu"
        o.flight_port = free_port() if flight else 0
        self.p = JaxParseable(o, JaxStorageOptions(backend="local-store", root=base / "store"))
        self.state = jax_app.ServerState(self.p)
        self.flight = None
        if flight:
            from parseable_tpu.server.flight import maybe_start_flight

            self.flight = maybe_start_flight(self.state)
        self.port, self._stop = _serve(jax_app.build_app(self.state))
        self.p.register_node(f"127.0.0.1:{self.port}")

    def stop(self) -> None:
        self._stop()
        if self.flight is not None:
            self.flight.stop()
        self.state.stop()
        self.p.shutdown()


def port_query(base, name, sql, engine="gpu", start=None, end=None, **opts):
    """One query on a fresh query-mode port node, over the API time range
    [start, end) where given; returns (rows, stats)."""
    o = Options()
    o.mode = Mode.QUERY
    o.local_staging_path = base / f"staging-{name}"
    o.query_result_cache_bytes = 0
    for k, v in {**FAST, **opts}.items():
        setattr(o, k, v)
    q = Parseable(o, StorageOptions(root=base / "store"))
    try:
        res = QuerySession(q, engine=engine, device="cpu").query(sql, start, end)
        return res.to_json_rows(), res.stats
    finally:
        q.shutdown()


def jax_query(base, name, sql, start=None, end=None, **opts):
    o = JaxOptions()
    o.mode = JaxMode.QUERY
    o.local_staging_path = base / f"staging-{name}"
    o.query_result_cache_bytes = 0
    for k, v in {**FAST, **opts}.items():
        setattr(o, k, v)
    q = JaxParseable(o, JaxStorageOptions(backend="local-store", root=base / "store"))
    try:
        res = JaxQuerySession(q, engine="cpu").query(sql, start, end)
        return res.to_json_rows(), res.stats
    finally:
        q.shutdown()


def boot(base, kind: str = "port", n: int = 2, seed: int = 7, sync_first: bool = True, **kw):
    """`n` ingestors of one package, each holding ROWS seeded rows of its
    own; with `sync_first` node 0 moves half of its rows into the lake
    before the other half arrives (staging and lake both in play)."""
    nodes = []
    for i in range(n):
        node = (PortNode if kind == "port" else JaxNode)(base, f"{kind}{i}", **kw)
        nodes.append(node)
        rows = make_rows(seed + i)
        if sync_first and i == 0:
            ingest(node.port, rows[: ROWS // 2])
            node.p.local_sync(shutdown=True)
            node.p.sync_all_streams()
            ingest(node.port, rows[ROWS // 2 :])
        else:
            ingest(node.port, rows)
    return nodes


def stop_all(nodes) -> None:
    for node in nodes:
        node.stop()


def same_rows(a: list[dict], b: list[dict], rel: float = REL, pct: tuple = ()) -> None:
    assert len(a) == len(b), (a, b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k, va in ra.items():
            vb = rb[k]
            if isinstance(va, float) or isinstance(vb, float):
                tol = PCT_REL if k in pct else rel
                assert va == pytest.approx(vb, rel=tol, abs=ABS), (k, ra, rb)
            else:
                assert va == vb, (k, ra, rb)


# -------------------------------------------------- pushdown vs references


@pytest.fixture(scope="module")
def both_clusters(tmp_path_factory):
    """The same seeded rows in a port cluster and in a JAX cluster."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_native, "_load", lambda: None)
        m.setattr(jax_native, "flatten_columnar", lambda *a, **k: None)
        m.setattr(jax_native, "flatten_ndjson", lambda *a, **k: None)
        port_base = tmp_path_factory.mktemp("port_cluster")
        jax_base = tmp_path_factory.mktemp("jax_cluster")
        port_nodes = boot(port_base, "port")
        jax_nodes = boot(jax_base, "jax")
        try:
            yield port_base, jax_base
        finally:
            stop_all(port_nodes + jax_nodes)


@pytest.mark.parametrize("qname", list(PUSHED))
def test_pushdown_matches_central_and_the_jax_cluster(both_clusters, qname):
    """A pushed-down GROUP BY equals the port's central path (the GPU
    engine's plain versions over the pulled staging windows and the lake)
    and the JAX cluster's pushdown over the same rows, with zero raw
    staging bytes moved."""
    port_base, jax_base = both_clusters
    sql = PUSHED[qname]
    pushed, pstats = port_query(port_base, "q-push", sql)
    central, cstats = port_query(port_base, "q-central", sql, query_pushdown=False)
    fan = pstats["stages"]["fanout"]
    assert fan["mode"] == "pushdown" and fan["ok"] == 2 and fan["fallback"] == 0, fan
    assert fan["fanin_bytes"] == 0 and fan["fallback_fanin_bytes"] == 0
    assert fan["transport"] == {"http": 2}
    assert cstats["stages"]["fanout"]["mode"] == "central"
    assert cstats["stages"]["fanout"]["fanin_bytes"] > 0
    assert cstats["device_routes"]["cpu_fallback"] == 0
    assert sum(r["c"] for r in pushed) > 0
    same_rows(pushed, central)
    jax_pushed, jstats = jax_query(jax_base, "q-jax", sql)
    assert jstats["stages"]["fanout"]["ok"] == 2
    same_rows(pushed, jax_pushed, rel=F64_REL)


def test_pushdown_moves_no_raw_staging_bytes(tmp_path, monkeypatch):
    """Every peer answers its partial: the querier never fetches a staging
    window, and no peer's staging route is hit."""
    hits = []
    orig = port_app.internal_staging

    async def counting(request):
        hits.append(request.path)
        return await orig(request)

    monkeypatch.setattr(port_app, "internal_staging", counting)
    fetches = []
    monkeypatch.setattr(C, "fetch_staging_batches", lambda *a, **k: fetches.append(a) or [])
    nodes = boot(tmp_path)
    try:
        # an API time range rides the scatter as resolved RFC 3339 bounds
        rows, stats = port_query(tmp_path, "q", PUSHED["status"], start="10m", end="now")
        assert sum(r["c"] for r in rows) == 2 * ROWS
        assert stats["stages"]["fanout"]["ok"] == 2
        assert hits == [] and fetches == []
    finally:
        stop_all(nodes)


# ------------------------------------------------------- counted exactly once


def test_staged_parquet_is_visible_before_upload_and_counted_once(tmp_path):
    """Rows converted to staged parquet but not yet uploaded stay visible to
    both paths, and once the upload commits them no row counts twice."""
    nodes = boot(tmp_path, sync_first=False)
    try:
        nodes[0].p.local_sync(shutdown=True)
        assert nodes[0].p.streams.get(STREAM).parquet_files()
        sql = "SELECT status, count(*) c FROM dist GROUP BY status ORDER BY status"
        for step in ("staged", "committed"):
            pushed, pstats = port_query(tmp_path, f"qp-{step}", sql)
            central, _ = port_query(tmp_path, f"qc-{step}", sql, query_pushdown=False)
            assert pstats["stages"]["fanout"]["ok"] == 2
            assert sum(r["c"] for r in pushed) == 2 * ROWS, step
            assert pushed == central, step
            nodes[0].p.sync_all_streams()
        assert nodes[0].p.streams.get(STREAM).parquet_files() == []
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_committed_staged_copy_is_not_counted_twice(tmp_path, package):
    """A staged parquet whose object the manifest already holds (committed,
    its local copy not yet gone) is served by the manifest scan alone."""
    nodes = boot(tmp_path, package, n=1, sync_first=False)
    p = nodes[0].p
    try:
        p.local_sync(shutdown=True)
        p.sync_all_streams()
        stream = p.streams.get(STREAM)
        assert stream.parquet_files() == []
        committed = [f for f in (tmp_path / "store").rglob("*.parquet") if STREAM in str(f)]
        assert committed
        for f in committed:
            shutil.copy2(f, stream.data_path / f.name)
        sql = "SELECT host, count(*) c FROM dist GROUP BY host"
        if package == "port":
            payload, meta = FO.execute_local_partial(p, STREAM, sql, None, None)
            table = FO.deserialize_table(payload)
        else:
            from parseable_tpu.query import fanout as jax_fanout

            payload, meta = jax_fanout.execute_local_partial(p, STREAM, sql, None, None)
            table = jax_fanout.deserialize_table(payload)
        assert meta["rows_scanned"] == ROWS, meta
        assert sum(table.column("__cnt").to_pylist()) == ROWS
    finally:
        stop_all(nodes)


# ------------------------------------------------------------ central path


@pytest.mark.parametrize("qname", list(CENTRAL))
def test_plans_without_a_partial_form_stay_central_on_the_gpu_engine(tmp_path, monkeypatch, qname):
    """Percentiles, count(distinct), an aggregate without GROUP BY and a
    select never scatter: the querier pulls the staging windows and
    answers on the GPU engine, every block on the device, as the CPU
    engine does."""
    hits = []
    orig = port_app.internal_query_partial

    async def counting(request):
        hits.append(request.path)
        return await orig(request)

    monkeypatch.setattr(port_app, "internal_query_partial", counting)
    nodes = boot(tmp_path)
    try:
        sql = CENTRAL[qname]
        gpu, gstats = port_query(tmp_path, "q-gpu", sql)
        cpu, _ = port_query(tmp_path, "q-cpu", sql, engine="cpu")
        assert hits == []
        fan = gstats["stages"]["fanout"]
        assert fan["mode"] == "central" and fan["fanin_bytes"] > 0 and fan["fanin_errors"] == 0
        routes = gstats["device_routes"]
        assert routes["cpu_fallback"] == 0, routes
        assert routes["device_cold"] + routes["device_warm"] > 0, routes
        assert gpu, qname
        same_rows(gpu, cpu, pct=("p50",))
    finally:
        stop_all(nodes)


# ------------------------------------------------------------- faulty peers


async def _partial_404(request):
    return web.json_response({"error": "no such route"}, status=404)


async def _partial_400(request):
    return web.json_response({"error": "plan rejected"}, status=400)


async def _partial_500(request):
    return web.json_response({"error": "boom"}, status=500)


async def _partial_wrong_tag(request):
    resp = await _REAL_PARTIAL(request)
    resp.headers[FO.H_TAG] = "someone-else."
    return resp


async def _partial_silent(request):
    await asyncio.sleep(3.0)  # past the attempt's 1 s timeout and its retry's
    return await _REAL_PARTIAL(request)


_REAL_PARTIAL = port_app.internal_query_partial
# handler, the failed peer's result, retries, the fan-out timeout (ms)
FAULTS = {
    "404": (_partial_404, "http_404", 0, 3000),
    "400": (_partial_400, "http_400", 0, 3000),
    "error": (_partial_500, "error", 1, 3000),
    "tag_mismatch": (_partial_wrong_tag, "tag_mismatch", 0, 3000),
    "silent": (_partial_silent, "error", 1, 1000),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_faulty_peer_falls_back_without_duplicate_or_dropped_groups(tmp_path, monkeypatch, fault):
    """One peer's partial route fails in one way; its slice (staging window
    and owned lake files) is served centrally, once, and the answer is the
    all-central one."""
    handler, reason, retries, timeout_ms = FAULTS[fault]
    monkeypatch.setattr(port_app, "internal_query_partial", handler)
    bad = boot(tmp_path, n=1, seed=7)  # node 0: half lake, half staging
    monkeypatch.setattr(port_app, "internal_query_partial", _REAL_PARTIAL)
    good = [PortNode(tmp_path, "good")]
    ingest(good[0].port, make_rows(8))
    try:
        pushed, stats = port_query(
            tmp_path, "q-push", PUSHED["status"], fanout_timeout_ms=timeout_ms
        )
        central, _ = port_query(tmp_path, "q-central", PUSHED["status"], query_pushdown=False)
        fan = stats["stages"]["fanout"]
        assert fan["ok"] == 1 and fan["fallback"] == 1 and fan["retries"] == retries, fan
        results = sorted(r["result"] for r in fan["per_peer"].values())
        assert results == sorted(["ok", reason]), fan
        assert fan["fallback_fanin_bytes"] > 0  # the failed peer's staging window
        assert sum(r["c"] for r in pushed) == 2 * ROWS
        same_rows(pushed, central)
    finally:
        stop_all(bad + good)


def test_a_dead_peer_is_skipped_on_both_paths(tmp_path):
    """A registered ingestor that nothing answers for fails its liveness
    probe and is left out of the scatter and of the fan-in alike."""
    nodes = boot(tmp_path)
    nodes[0].p.metastore.put_node(
        {
            "node_id": "deadnode",
            "node_type": "ingestor",
            "domain_name": f"http://127.0.0.1:{free_port()}",
            "owner_tag": "deadhost.",
        }
    )
    try:
        pushed, stats = port_query(tmp_path, "q-push", PUSHED["status"])
        C._dead_nodes.clear()
        central, _ = port_query(tmp_path, "q-central", PUSHED["status"], query_pushdown=False)
        fan = stats["stages"]["fanout"]
        assert fan["peers"] == 2 and fan["ok"] == 2 and fan["fallback"] == 0, fan
        assert sum(r["c"] for r in pushed) == 2 * ROWS
        same_rows(pushed, central)
    finally:
        stop_all(nodes)


def test_a_hedged_slow_peer_counts_once(tmp_path, monkeypatch):
    """A peer slow on its first answer gets a hedged duplicate; one of the
    two answers merges and the other is dropped."""
    calls = []

    async def slow_once(request):
        calls.append(time.monotonic())
        if len(calls) == 1:
            await asyncio.sleep(1.0)
        return await _REAL_PARTIAL(request)

    monkeypatch.setattr(port_app, "internal_query_partial", slow_once)
    nodes = boot(tmp_path, n=1)
    try:
        pushed, stats = port_query(
            tmp_path, "q-push", PUSHED["status"], fanout_timeout_ms=3000, fanout_hedge_ms=120
        )
        central, _ = port_query(tmp_path, "q-central", PUSHED["status"], query_pushdown=False)
        fan = stats["stages"]["fanout"]
        assert fan["hedged"] == 1 and fan["ok"] == 1 and fan["fallback"] == 0, fan
        assert len(calls) == 2
        assert sum(r["c"] for r in pushed) == ROWS
        same_rows(pushed, central)
    finally:
        stop_all(nodes)


# ------------------------------------------------------------------ Flight


@pytest.mark.parametrize("query_pushdown", [True, False], ids=["pushdown", "central"])
def test_the_flight_tier_answers_as_the_http_tier(tmp_path, query_pushdown):
    """Ingestors that serve Flight answer the scatter and the fan-in over
    it, with the HTTP tier's answer."""
    nodes = boot(tmp_path, flight=True)
    try:
        for n in nodes:
            assert n.server.state.flight is not None
        sql = PUSHED["host_status"]
        flight, fstats = port_query(tmp_path, "q-flight", sql, query_pushdown=query_pushdown)
        via_http, hstats = port_query(
            tmp_path, "q-http", sql, query_pushdown=query_pushdown, flight_client=False
        )
        ffan, hfan = fstats["stages"]["fanout"], hstats["stages"]["fanout"]
        if query_pushdown:
            assert ffan["transport"] == {"flight": 2} and ffan["ok"] == 2, ffan
            assert hfan["transport"] == {"http": 2}, hfan
        else:
            assert ffan["transport"]["flight_peers"] == 2 and "http_bytes" not in ffan["transport"]
            assert hfan["transport"]["http_bytes"] > 0 and "flight_bytes" not in hfan["transport"]
        # the central path's f32 sums meet the batches in arrival order
        same_rows(flight, via_http)
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("query_pushdown", [True, False], ids=["pushdown", "central"])
def test_a_flight_decline_falls_back_to_http(tmp_path, query_pushdown):
    """A registry entry whose Flight endpoint answers nothing: every call
    declines to HTTP and the answer is unchanged."""
    nodes = boot(tmp_path)
    try:
        sql = PUSHED["status"]
        want, _ = port_query(tmp_path, "q-want", sql, query_pushdown=query_pushdown)
        for n in nodes:
            node = next(
                x for x in n.p.metastore.list_nodes("ingestor") if x["node_id"] == n.p.node_id
            )
            node["flight_url"] = f"grpc://127.0.0.1:{free_port()}"
            n.p.metastore.put_node(node)
        got, stats = port_query(tmp_path, "q-got", sql, query_pushdown=query_pushdown)
        fan = stats["stages"]["fanout"]
        if query_pushdown:
            assert fan["transport"] == {"http": 2, "flight_declines": 2}, fan
        else:
            assert fan["transport"]["flight_fallbacks"] == 2 and fan["transport"]["http_bytes"] > 0
        same_rows(got, want)
    finally:
        stop_all(nodes)


# ----------------------------------------------------------- staging route


def test_the_staging_route_honours_time_bounds_and_projection(tmp_path):
    """GET /api/v1/internal/staging/{s} keeps rows in [start, end) and the
    asked columns (with p_timestamp), and answers 204 when nothing is left."""
    nodes = boot(tmp_path, n=1, sync_first=False)
    port = nodes[0].port
    try:
        status, body, _ = http(port, "GET", f"/api/v1/internal/staging/{STREAM}")
        assert status == 200
        full = FO.deserialize_table(body)
        assert full.num_rows == ROWS
        assert {"host", "status", "bytes", "lat", "p_timestamp"} <= set(full.column_names)
        status, body, _ = http(port, "GET", f"/api/v1/internal/staging/{STREAM}?fields=host,lat")
        assert status == 200
        assert sorted(FO.deserialize_table(body).column_names) == ["host", "lat", "p_timestamp"]
        future = "2999-01-01T00:00:00Z"
        status, _, _ = http(port, "GET", f"/api/v1/internal/staging/{STREAM}?start={future}")
        assert status == 204
        past = "2000-01-01T00:00:00Z"
        status, body, _ = http(
            port, "GET", f"/api/v1/internal/staging/{STREAM}?start={past}&end={future}&fields=bytes"
        )
        assert status == 200
        bounded = FO.deserialize_table(body)
        assert bounded.num_rows == ROWS and sorted(bounded.column_names) == ["bytes", "p_timestamp"]
        status, _, _ = http(port, "GET", f"/api/v1/internal/staging/{STREAM}?start=not-a-time")
        assert status == 400
        status, _, _ = http(port, "GET", "/api/v1/internal/staging/nosuchstream")
        assert status == 204
    finally:
        stop_all(nodes)


# ---------------------------------------------------------- combine_partials


def _partials(pkg, sql: str, table: pa.Table, blocks: int):
    """Per-block partials of `sql` over `table` cut in `blocks` blocks, with
    one package's planner and partials module."""
    planner, sql_mod, executor, partials = pkg
    lp = planner.plan(sql_mod.parse_sql(sql))
    agg, _rw, _names = executor.QueryExecutor(lp).build_aggregator()
    n = table.num_rows
    parts = [
        partials.partial_from_block(table.slice(o, n // blocks), lp.select.group_by, agg.specs)
        for o in range(0, n, n // blocks)
    ]
    return [p for p in parts if p is not None], agg.specs, len(lp.select.group_by)


@pytest.mark.parametrize("qname", list(PUSHED))
def test_combine_partials_equals_the_jax_function(qname):
    rng = np.random.default_rng(3)
    n = 1000
    table = pa.table(
        {
            "host": pa.array(rng.choice(["a", "b", "c", None], n).tolist()),
            "status": pa.array(rng.choice([200, 404, 500], n).astype(np.int64)),
            "bytes": pa.array(rng.integers(0, 5000, n).astype(np.int64)),
            "lat": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.random(n) * 500)),
        }
    )
    sql = PUSHED[qname].split(" ORDER BY")[0].replace(" WHERE bytes >= 1000", "")
    port = _partials((port_planner, port_sql, port_executor, port_partials), sql, table, 4)
    jax = _partials((jax_planner, jax_sql, jax_executor, jax_partials), sql, table, 4)
    got = port_partials.combine_partials(*port)
    want = jax_partials.combine_partials(*jax)
    assert got.column_names == want.column_names
    keys = [c for c in got.column_names if c.startswith("__g")]

    def rows(t):
        return sorted(t.to_pylist(), key=lambda r: [(r[k] is None, r[k] or 0) for k in keys])

    got, want = rows(got), rows(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float) and not np.isnan(v):
                assert g[k] == pytest.approx(v, rel=F64_REL), (k, g, w)
            elif isinstance(v, float):
                assert np.isnan(g[k])
            else:
                assert g[k] == v, (k, g, w)


# ------------------------------------------------------------ across packages


@pytest.mark.parametrize("query_pushdown", [True, False], ids=["pushdown", "central"])
@pytest.mark.parametrize("ingestors", ["jax", "port"])
def test_a_querier_of_one_package_reads_ingestors_of_the_other(tmp_path, ingestors, query_pushdown):
    """The wire is one protocol: a port querier over JAX ingestors and a JAX
    querier over port ingestors give the table the ingestors' own package's
    querier gives."""
    nodes = boot(tmp_path, ingestors)
    try:
        sql = PUSHED["status"]
        span = {"start": "10m", "end": "now", "query_pushdown": query_pushdown}
        port_side = lambda name: port_query(tmp_path, name, sql, engine="cpu", **span)  # noqa: E731
        jax_side = lambda name: jax_query(tmp_path, name, sql, **span)  # noqa: E731
        own_q, other_q = (port_side, jax_side) if ingestors == "port" else (jax_side, port_side)
        own, own_stats = own_q("q-own")
        other, other_stats = other_q("q-other")
        for stats in (own_stats, other_stats):
            fan = stats["stages"]["fanout"]
            if query_pushdown:
                assert fan["ok"] == 2 and fan["fallback"] == 0, fan
            else:
                assert fan["mode"] == "central" and fan["fanin_bytes"] > 0, fan
        assert sum(r["c"] for r in own) == 2 * ROWS
        same_rows(other, own, rel=F64_REL)
    finally:
        stop_all(nodes)


# ----------------------------------------------- a commit between two reads

# rows counted when an upload commit lands just before or just after the
# querier's staging fan-in: the port reads the manifest list before the
# fan-in, the JAX package after it
RACE = {
    ("port", "before"): 0,  # between the port's reads: the file is in neither
    ("port", "after"): ROWS,
    ("jax", "before"): ROWS,
    ("jax", "after"): 2 * ROWS,  # between the JAX reads: in both
}


@pytest.mark.parametrize("package,when", list(RACE))
def test_a_commit_beside_the_fan_in(tmp_path, monkeypatch, package, when):
    """The central path reads the manifest list and the peers' staging
    windows at two moments. An upload that commits a staged file between
    them makes that one answer wrong: the port (manifest, then fan-in)
    misses the file's rows, the JAX package (fan-in, then manifest) counts
    them twice. A commit on the other side of the fan-in is counted once.
    The next query is right in every case (ROADMAP §3)."""
    nodes = boot(tmp_path, package, n=1, sync_first=False)
    p = nodes[0].p
    try:
        p.local_sync(shutdown=True)  # every row now staged parquet, unclaimed
        mod = C if package == "port" else jax_cluster
        orig = mod.fetch_staging_batches

        def fetch_beside_a_commit(*a, **k):
            if when == "before":
                p.sync_all_streams()  # upload, commit and unlink
            out = orig(*a, **k)
            if when == "after":
                p.sync_all_streams()
            return out

        monkeypatch.setattr(mod, "fetch_staging_batches", fetch_beside_a_commit)
        sql = "SELECT count(*) c FROM dist WHERE bytes >= 0"
        query = port_query if package == "port" else jax_query
        rows, _ = query(tmp_path, "q-race", sql, query_pushdown=False)
        assert rows == [{"c": RACE[package, when]}]
        monkeypatch.setattr(mod, "fetch_staging_batches", orig)
        rows, _ = query(tmp_path, "q-after", sql, query_pushdown=False)
        assert rows == [{"c": ROWS}]
    finally:
        stop_all(nodes)


# -------------------------------------------------------------------- card


def test_an_ingest_node_serves_without_a_card_and_builds_nothing(tmp_path, monkeypatch):
    """With the default engine ("gpu") an ingest node neither probes a
    device nor builds a kernel, and serves ingest, its staging window and
    partials; a query node with "gpu" and no card refuses to start."""

    def no_card(*a, **k):
        raise AssertionError("an ingest node touched the card")

    monkeypatch.setattr(cuda_lib, "build_all", no_card)
    monkeypatch.setattr(devicecheck, "probe", no_card)
    monkeypatch.setattr(devicecheck, "require_device", no_card)
    node = PortNode(tmp_path, "ing")
    try:
        assert node.p.options.query_engine == "gpu" and node.server.state.device is None
        status, body, _ = http(node.port, "GET", "/api/v1/about")
        assert status == 200 and json.loads(body)["mode"] == "Ingest"
        ingest(node.port, make_rows(1))
        status, _, _ = http(node.port, "POST", "/api/v1/query", b'{"query": "select 1"}')
        assert status == 404  # an ingest node answers no query
        status, body, headers = http(
            node.port,
            "POST",
            f"/api/v1/internal/query/partial/{STREAM}",
            json.dumps({"query": "SELECT host, count(*) c FROM dist GROUP BY host"}).encode(),
        )
        assert status == 200 and headers[FO.H_TAG] == node.p.owner_tag
        assert sum(FO.deserialize_table(body).column("__cnt").to_pylist()) == ROWS
        reg = node.p.metastore.list_nodes("ingestor")
        assert [n["owner_tag"] for n in reg] == [node.p.owner_tag]
        assert node.p.owner_tag.endswith(node.p.node_id + ".")
    finally:
        node.stop()
    monkeypatch.undo()
    if devicecheck.probe("cuda").get("available"):
        pytest.skip("this machine has a card")
    o = Options()
    o.mode = Mode.QUERY
    o.address = "127.0.0.1:0"
    o.local_staging_path = tmp_path / "staging-q"
    with pytest.raises(devicecheck.DeviceUnavailable):
        start_server(o, StorageOptions(root=tmp_path / "store"))


def test_owner_tags_of_two_ingestors_in_one_process_differ(tmp_path):
    """Two ingestors on one host share the hostname: their owner tags (and
    so the names of the files they stage and upload) differ by node id, and
    each snapshot counts only its own files."""
    nodes = boot(tmp_path, sync_first=False)
    try:
        for n in nodes:
            n.p.local_sync(shutdown=True)
            n.p.sync_all_streams()
        tags = [n.p.owner_tag for n in nodes]
        assert tags[0] != tags[1]
        names = [f.name for f in (tmp_path / "store").rglob("*.parquet")]
        assert sorted(t for t in tags for f in names if f.startswith(t)) == sorted(tags)
        for n in nodes:
            fmt = n.p.metastore.get_stream_json(STREAM, n.p.node_id)
            assert fmt.stats.events == ROWS
    finally:
        stop_all(nodes)


def test_a_query_node_sends_stream_changes_to_the_ingestors(tmp_path):
    """A stream created or deleted on the query node reaches every live
    ingestor (in the background); the query node takes no ingest."""
    ing = PortNode(tmp_path, "ing")
    q = PortNode(tmp_path, "q", mode=Mode.QUERY, device="cpu")
    try:
        status, body, _ = http(q.port, "GET", "/api/v1/about")
        assert json.loads(body)["mode"] == "Query"
        status, _, _ = http(q.port, "POST", "/api/v1/ingest", b"[]", {"X-P-Stream": STREAM})
        assert status == 404

        def wait(cond) -> bool:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not cond():
                time.sleep(0.05)
            return cond()

        status, _, _ = http(q.port, "PUT", "/api/v1/logstream/fresh")
        assert status == 200
        assert wait(lambda: ing.p.streams.contains("fresh"))
        status, _, _ = http(q.port, "DELETE", "/api/v1/logstream/fresh")
        assert status == 200
        assert wait(lambda: not ing.p.streams.contains("fresh"))
    finally:
        q.stop()
        ing.stop()
