"""The port's HTTP server against the JAX package's, on the CPU.

The port's app runs its GPU engine with `device="cpu"` (the kernels' plain
versions); the JAX package's app runs its CPU engine. Both take the same
requests and must answer with the same status codes and JSON bodies. The
JAX app is never sent rows to ingest here (its ingest loads its native
library; tests/test_torch_ingest.py holds those comparisons): it answers
queries over the lake the port's server wrote instead.

Servers listen on port 0; data lives under `tmp_path`. Tolerances: counts
and keys exact, floats rel 2e-4, abs 1e-6.
"""

import asyncio
import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.config import StorageOptions as JaxStorageOptions
from parseable_tpu.core import Parseable as JaxParseable
from parseable_tpu.server import app as jax_app
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.server import app as port_app
from parseable_tpu_torch.utils.devicecheck import DeviceUnavailable

TOL = dict(rel=2e-4, abs=1e-6)
ROOT = Path(__file__).resolve().parents[1]
STREAM = "weblogs"
AUTH = {"Authorization": "Basic " + base64.b64encode(b"admin:admin").decode()}
BAD_PW = {"Authorization": "Basic " + base64.b64encode(b"admin:wrong").decode()}


def port_options(base: Path) -> Options:
    opts = Options()
    opts.local_staging_path = base / "staging"
    opts.address = "127.0.0.1:0"
    opts.max_event_payload_bytes = 4096
    return opts


def jax_state(base: Path) -> jax_app.ServerState:
    opts = JaxOptions()
    opts.local_staging_path = base / "jax_staging"
    opts.query_engine = "cpu"
    opts.max_event_payload_bytes = 4096
    return jax_app.ServerState(
        JaxParseable(opts, JaxStorageOptions(backend="local-store", root=base / "data"))
    )


def port_state(base: Path) -> port_app.ServerState:
    return port_app.ServerState(
        Parseable(port_options(base), StorageOptions(root=base / "data")), device="cpu"
    )


async def _answers(app, requests) -> list[tuple[int, object]]:
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = []
        for method, path, headers, body in requests:
            r = await client.request(method, path, data=body, headers=headers)
            text = await r.text()
            out.append((r.status, json.loads(text) if text else None))
        return out
    finally:
        await client.close()


def answers(state, app_module, requests):
    try:
        return asyncio.new_event_loop().run_until_complete(
            _answers(app_module.build_app(state), requests)
        )
    finally:
        state.stop()


def query_body(sql: str, **extra) -> bytes:
    return json.dumps({"query": sql, "startTime": "10m", "endTime": "now", **extra}).encode()


SAME_ANSWERS = {
    "liveness": [("GET", "/api/v1/liveness", {}, None)],
    "readiness": [("GET", "/api/v1/readiness", {}, None)],
    "no credentials": [("GET", "/api/v1/logstream", {}, None)],
    "wrong password": [("GET", "/api/v1/logstream", BAD_PW, None)],
    "bad basic header": [("GET", "/api/v1/logstream", {"Authorization": "Basic %%%"}, None)],
    "ingest without credentials": [
        ("POST", "/api/v1/ingest", {"X-P-Stream": STREAM}, b"[]")
    ],
    "ingest without stream header": [("POST", "/api/v1/ingest", AUTH, b'[{"a": 1}]')],
    "ingest past the payload cap": [
        ("POST", "/api/v1/ingest", {**AUTH, "X-P-Stream": STREAM},
         json.dumps([{"message": "x" * 100}] * 60).encode())
    ],
    "ingest otel to the json route": [
        ("POST", "/api/v1/ingest",
         {**AUTH, "X-P-Stream": STREAM, "X-P-Log-Source": "otel-traces"}, b"{}")
    ],
    "stream crud": [
        ("PUT", f"/api/v1/logstream/{STREAM}", AUTH, None),
        ("PUT", f"/api/v1/logstream/{STREAM}", AUTH, None),
        ("GET", "/api/v1/logstream", AUTH, None),
        ("GET", f"/api/v1/logstream/{STREAM}/schema", AUTH, None),
        ("DELETE", f"/api/v1/logstream/{STREAM}", AUTH, None),
        ("GET", "/api/v1/logstream", AUTH, None),
        ("DELETE", f"/api/v1/logstream/{STREAM}", AUTH, None),
    ],
    "invalid stream names": [
        ("PUT", "/api/v1/logstream/1abc", AUTH, None),
        ("PUT", "/api/v1/logstream/pmeta", AUTH, None),
        ("PUT", "/api/v1/logstream/a.b", AUTH, None),
    ],
    "schema of a missing stream": [("GET", "/api/v1/logstream/nope/schema", AUTH, None)],
    "query with a body that is not JSON": [("POST", "/api/v1/query", AUTH, b"{nope")],
    "query without sql": [("POST", "/api/v1/query", AUTH, b'{"startTime": "10m"}')],
    "query of a missing stream": [
        ("POST", "/api/v1/query", AUTH, query_body("SELECT count(*) AS c FROM nope"))
    ],
    "query with bad sql": [
        ("POST", "/api/v1/query", AUTH, query_body(f"SELEC host FROM {STREAM}"))
    ],
    "query with a bad time range": [
        ("POST", "/api/v1/query", AUTH,
         json.dumps({"query": f"SELECT count(*) FROM {STREAM}", "startTime": "10x",
                     "endTime": "now"}).encode())
    ],
}


@pytest.mark.parametrize("case", sorted(SAME_ANSWERS))
def test_answers_match_the_jax_app(tmp_path, case):
    requests = SAME_ANSWERS[case]
    want = answers(jax_state(tmp_path / "jax"), jax_app, requests)
    got = answers(port_state(tmp_path / "port"), port_app, requests)
    assert got == want
    if case == "stream crud":
        assert [s for s, _ in got] == [200, 400, 200, 200, 200, 200, 404]


def http(port: int, method: str, path: str, body: bytes | None = None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={**AUTH, **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def events(seed: int, n: int) -> list[dict]:
    hosts = [f"10.0.0.{i}" for i in range(4)]
    return [
        {"host": hosts[(seed + i) % 4], "status": [200, 404, 500][(seed * 7 + i) % 3],
         "bytes": 100 + (seed * 31 + i * 17) % 900, "req": {"path": f"/r{i % 3}"}}
        for i in range(n)
    ]


def ingest_concurrently(port: int, threads: int = 4, requests: int = 5, rows: int = 20) -> int:
    acked = []
    lock = threading.Lock()

    def client(t: int) -> None:
        for r in range(requests):
            status, body = http(port, "POST", "/api/v1/ingest",
                                json.dumps(events(t * 100 + r, rows)).encode(),
                                {"X-P-Stream": STREAM})
            assert status == 200, body
            with lock:
                acked.append(int(body["message"].split()[1]))

    workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    assert not any(w.is_alive() for w in workers)
    assert len(acked) == threads * requests
    return sum(acked)


def count(port: int) -> int:
    status, body = http(port, "POST", "/api/v1/query",
                        query_body(f"SELECT count(*) AS c FROM {STREAM}", fields=True))
    assert status == 200, body
    assert body["stats"]["device_routes"]["cpu_fallback"] == 0
    return body["records"][0]["c"]


def test_restart_keeps_every_acknowledged_row(tmp_path):
    """Rows acked over HTTP are counted from staging, then, after a stop
    (flush, convert, upload) and a start on the same directories, from the
    lake; the stream comes back with its schema."""
    opts, storage = port_options(tmp_path), StorageOptions(root=tmp_path / "data")
    opts.max_event_payload_bytes = 1 << 20
    server = port_app.start_server(opts, storage, device="cpu")
    try:
        acked = ingest_concurrently(server.port)
        assert count(server.port) == acked
        status, body = http(server.port, "POST", f"/api/v1/logstream/{STREAM}",
                            json.dumps(events(9, 5)).encode())
        assert (status, body) == (200, {"message": "ingested 5 records"})
        acked += 5
    finally:
        server.stop()
    staging = tmp_path / "staging" / STREAM
    assert not [f for f in staging.iterdir() if f.suffix in (".arrows", ".parquet")]
    server = port_app.start_server(opts, storage, device="cpu")
    try:
        assert count(server.port) == acked
        status, body = http(server.port, "GET", "/api/v1/logstream")
        assert body == [{"name": STREAM}]
        status, body = http(server.port, "GET", f"/api/v1/logstream/{STREAM}/schema")
        assert {f["name"] for f in body["fields"]} == {
            "p_timestamp", "host", "status", "bytes", "req_path"
        }
    finally:
        server.stop()


def test_jax_app_answers_the_same_queries_over_the_ports_lake(tmp_path):
    opts, storage = port_options(tmp_path), StorageOptions(root=tmp_path / "data")
    opts.max_event_payload_bytes = 1 << 20
    server = port_app.start_server(opts, storage, device="cpu")
    try:
        ingest_concurrently(server.port, threads=2)
        queries = [
            f"SELECT host, count(*) AS c, sum(bytes) AS b, min(bytes) AS mn, max(bytes) AS mx "
            f"FROM {STREAM} GROUP BY host ORDER BY host",
            f"SELECT req_path, status, count(*) AS c FROM {STREAM} GROUP BY req_path, status "
            f"ORDER BY c DESC, req_path, status LIMIT 5",
            f"SELECT count(*) AS c, avg(bytes) AS a FROM {STREAM} WHERE status >= 400",
        ]
        staged = [http(server.port, "POST", "/api/v1/query", query_body(q, fields=True))
                  for q in queries]
    finally:
        server.stop()
    server = port_app.start_server(opts, storage, device="cpu")
    try:
        lake = [http(server.port, "POST", "/api/v1/query", query_body(q, fields=True))
                for q in queries]
    finally:
        server.stop()
    requests = [("POST", "/api/v1/query", AUTH, query_body(q, fields=True)) for q in queries]
    jax_out = answers(jax_state(tmp_path), jax_app, requests)
    for (js, jb), (ss, sb), (ls, lb) in zip(jax_out, staged, lake):
        assert js == ss == ls == 200
        assert jb["fields"] == sb["fields"] == lb["fields"]
        for got in (sb["records"], lb["records"]):
            assert len(got) == len(jb["records"])
            for a, b in zip(jb["records"], got):
                assert a.keys() == b.keys()
                for k in a:
                    if isinstance(a[k], float):
                        assert b[k] == pytest.approx(a[k], **TOL)
                    else:
                        assert b[k] == a[k]
        assert lb["stats"]["staging_rows"] == 0 and sb["stats"]["staging_rows"] > 0


def test_queries_racing_the_sync_ticks_count_each_row_once(tmp_path):
    """While one thread ingests and another runs the sync ticks (arrows ->
    parquet -> lake), every count(*) lies between the rows acked before it
    started and the rows pushed (acked or in flight) when it ended: no row
    is lost or counted twice as it moves from staging into the lake."""
    p = Parseable(port_options(tmp_path), StorageOptions(root=tmp_path / "data"))
    from parseable_tpu_torch.event.format import LogSource
    from parseable_tpu_torch.server.ingest_utils import flatten_and_push_logs

    p.create_stream_if_not_exists(STREAM)
    acked, pushed = [0], [0]
    lock = threading.Lock()
    stop = threading.Event()
    errors: list[BaseException] = []

    def ingester() -> None:
        i = 0
        while not stop.is_set():
            batch = events(i, 7)
            with lock:
                pushed[0] += len(batch)
            n = flatten_and_push_logs(p, STREAM, batch, LogSource.JSON)
            with lock:
                acked[0] += n
            i += 1

    def syncer() -> None:
        while not stop.is_set():
            p.sync_cycle()
            p.sync_all_streams()

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # surfaced by the assertion below
                errors.append(e)
        return run

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=guarded(f)) for f in (ingester, syncer)]
    try:
        for t in threads:
            t.start()
        sql = f"SELECT count(*) AS c FROM {STREAM}"
        for _ in range(25):
            with lock:
                before = acked[0]
            # no time range: a bound at "now" would cut the rows acked while
            # the query runs
            res = QuerySession(p, engine="gpu", device="cpu").query(sql)
            with lock:
                after = pushed[0]
            c = res.table.to_pylist()[0]["c"]
            assert before <= c <= after, (before, c, after)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
        p.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert p.metastore.get_stream_json(STREAM).stats.events == acked[0] == pushed[0]


def test_gpu_engine_without_a_card_refuses_to_start(tmp_path, monkeypatch):
    """`P_QUERY_ENGINE=gpu` (the default) without a working card: the server
    raises with the device probe's report instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Parseable(port_options(tmp_path), StorageOptions(root=tmp_path / "data"))
    assert p.options.query_engine == "gpu"
    with pytest.raises(DeviceUnavailable, match="probe"):
        port_app.ServerState(p)
    p.shutdown()
    with pytest.raises(DeviceUnavailable):
        port_app.start_server(port_options(tmp_path), StorageOptions(root=tmp_path / "data"))
    cpu_opts = port_options(tmp_path)
    cpu_opts.query_engine = "cpu"
    port_app.ServerState(Parseable(cpu_opts, StorageOptions(root=tmp_path / "data"))).stop()


def test_server_module_refuses_to_start_without_a_card(tmp_path):
    """`python -m parseable_tpu_torch.server` exits non-zero where CUDA shows
    no card (none here, none visible on a card machine), naming the probe's
    report."""
    env = {
        **os.environ,
        "CUDA_VISIBLE_DEVICES": "",
        "P_ADDR": "127.0.0.1:0",
        "P_STAGING_DIR": str(tmp_path / "staging"),
        "P_FS_DIR": str(tmp_path / "data"),
    }
    env.pop("P_QUERY_ENGINE", None)
    out = subprocess.run(
        [sys.executable, "-m", "parseable_tpu_torch.server"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode != 0
    assert "DeviceUnavailable" in out.stderr and "torch.cuda.is_available() is False" in out.stderr
