"""The port's ingest half against the JAX package's, on the CPU.

The same seeded JSON payloads (nested objects, arrays, nulls, an int ->
string type conflict, a timestamp-like field) go through both packages'
Python lane: `flatten_json_records` + `push_logs` -> staging (Arrow IPC)
-> `local_sync(shutdown=True)` (Parquet) -> `sync_all_streams` (object
store + manifest/snapshot). At each step the staged batches, Parquet files,
stream JSON and manifests must match, modulo what differs by design: the
schema key in staging file names (the JAX package hashes it with its
native library when that loads), per-conversion ids, and arrival times
(`p_timestamp` is checked to lie within the ingest call's window instead).
Then each package reads the lake the other wrote, and both apps answer
the same HTTP ingest requests with the same bodies.

Every ingest call into the JAX package in the port's tests that may load
its native library is in this file (`tests/test_torch_native.py` keeps the
JAX package on its Python lane), and so is every statistics comparison
that needs the JAX package's native library (its xxHash64, which approx_distinct hashes with). A fresh checkout
builds that library in place at its first load, and a worker that loads it
while another worker's build is still writing it caches the failure for
its whole session. So this module, which every xdist worker imports while
collecting, loads it once under a file lock (`_load_jax_native_once`)
before any test runs: the first worker builds it, the others wait and load
the finished file. The statistics comparisons (the statistics slice,
approx_distinct and the HLL sketch) sit at the end and share
`tests/test_torch_stats.py`'s helpers and tolerances.

Tolerances: counts, keys and strings exact; floats rel 2e-4, abs 1e-6 (the
GPU engine's f32 partials against f64 engines).
"""

import asyncio
import base64
import fcntl
import json
import re
from datetime import UTC, datetime
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from aiohttp.test_utils import TestClient, TestServer

import parseable_tpu.ops.hll_sketch as JH
from parseable_tpu import native
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.config import StorageOptions as JaxStorageOptions
from parseable_tpu.core import Parseable as JaxParseable
from parseable_tpu.event.format import LogSource as JaxLogSource
from parseable_tpu.query import executor_tpu as ET
from parseable_tpu.query.session import QuerySession as JaxSession
from parseable_tpu.server import app as jax_app
from parseable_tpu.server.ingest_utils import flatten_json_records as jax_flatten
from parseable_tpu.server.ingest_utils import push_logs as jax_push
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.event.format import LogSource, get_schema_key, xxh64
from parseable_tpu_torch.ops import hll_sketch as PH
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.server import app as port_app
from parseable_tpu_torch.server.ingest_utils import flatten_json_records, push_logs
from tests.test_torch_stats import (
    STATS_CASES,
    assert_stats,
    jax_cpu,
    jax_tpu,
    port_cpu,
    port_gpu,
    stats_table,
    tables,  # noqa: F401 (a fixture)
)


def _load_jax_native_once() -> None:
    """Load (building it if it is missing) the JAX package's native library
    under a lock in the gitignored `build/`, so no two processes build it at
    once (module docstring)."""
    lock_dir = Path(__file__).resolve().parents[1] / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / ".jax_native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._load()


_load_jax_native_once()

TOL = dict(rel=2e-4, abs=1e-6)
STREAM = "weblogs"
AUTH = {"Authorization": "Basic " + base64.b64encode(b"admin:admin").decode()}
QUERIES = [
    f"SELECT count(*) AS c FROM {STREAM}",
    f"SELECT host, count(*) AS c, sum(bytes) AS b, min(latency_ms) AS mn, "
    f"max(bytes) AS mx FROM {STREAM} GROUP BY host",
    f"SELECT status, count(*) AS c FROM {STREAM} WHERE message LIKE '%error%' GROUP BY status",
    f"SELECT req_method, count(*) AS c, avg(latency_ms) AS l FROM {STREAM} GROUP BY req_method",
]


def payloads(seed: int, n: int = 3, rows: int = 60) -> list[list[dict]]:
    """Access-log-like JSON batches. Batch 0 types `status` as a number and
    batch 1 sends some statuses as strings (a per-record rename to
    `status_str`); records nest an object (`req`), carry arrays (`tags`,
    expanded into rows; `spans`, an array of objects), nulls, and a
    timestamp-like string field (`created_at`)."""
    rng = np.random.default_rng(seed)
    hosts = [f"10.0.0.{i}" for i in range(5)]
    messages = ["request completed", "error: upstream timeout", "cache miss", "error: denied"]
    out = []
    for b in range(n):
        batch = []
        for i in range(rows):
            rec = {
                "host": hosts[rng.integers(len(hosts))],
                "status": int(rng.choice([200, 404, 500])),
                "bytes": int(rng.integers(100, 5000)),
                "latency_ms": float(np.round(rng.random() * 500, 3)),
                "message": messages[rng.integers(len(messages))],
                "req": {"method": ["GET", "POST"][i % 2], "path": f"/r{rng.integers(4)}"},
                "created_at": f"2024-05-01T10:{rng.integers(60):02d}:00Z",
                "user": None if rng.random() < 0.3 else f"u{rng.integers(3)}",
            }
            if b == 1 and i % 4 == 0:
                rec["status"] = "ok"
            if i % 7 == 0:
                rec["tags"] = ["a", "b"]
            if i % 11 == 0:
                rec["spans"] = [{"id": 1, "ok": True}, {"id": 2, "ok": None}]
            batch.append(rec)
        out.append(batch)
    return out


def jax_at(tmp_path, name: str) -> JaxParseable:
    opts = JaxOptions()
    opts.local_staging_path = tmp_path / name / "staging"
    opts.query_engine = "cpu"
    return JaxParseable(opts, JaxStorageOptions(backend="local-store", root=tmp_path / name / "data"))


def port_at(tmp_path, name: str) -> Parseable:
    opts = Options()
    opts.local_staging_path = tmp_path / name / "staging"
    return Parseable(opts, StorageOptions(root=tmp_path / name / "data"))


def ingest(p, flatten_fn, push_fn, source, batches) -> int:
    p.create_stream_if_not_exists(STREAM)
    total = 0
    for batch in batches:
        body = json.dumps(batch)
        rows = flatten_fn(body and json.loads(body), 10, None, None, None, 24)
        total += push_fn(p, STREAM, rows, source, {}, len(body))
    return total


@pytest.fixture
def both(tmp_path):
    """One JAX and one port instance, each fed the same payloads."""
    jp, pp = jax_at(tmp_path, "jax"), port_at(tmp_path, "port")
    t0 = datetime.now(UTC).replace(tzinfo=None)
    batches = payloads(7)
    n_jax = ingest(jp, jax_flatten, jax_push, JaxLogSource.JSON, batches)
    n_port = ingest(pp, flatten_json_records, push_logs, LogSource.JSON, batches)
    t1 = datetime.now(UTC).replace(tzinfo=None)
    assert n_jax == n_port > 0
    yield jp, pp, (t0, t1)
    jp.shutdown()
    pp.shutdown()


def without_time(table: pa.Table, window) -> list[dict]:
    """Rows without p_timestamp, after checking it lies in `window`
    (ms floor of the call's start, the call's end)."""
    ts = table.column("p_timestamp").to_pylist()
    lo = window[0].replace(microsecond=window[0].microsecond // 1000 * 1000)
    assert all(lo <= t <= window[1] for t in ts), (min(ts), max(ts), window)
    rows = table.drop_columns(["p_timestamp"]).to_pylist()
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True, default=str))


def masked(name: str) -> str:
    """A staging name with its schema key, minute bucket and
    per-conversion id masked."""
    name = re.sub(r"^[0-9a-f]{16}\.", "KEY.", name)
    name = re.sub(r"date=[0-9-]+\.hour=\d\d\.minute=\d\d", "date=D.hour=H.minute=M", name)
    return re.sub(r"\.[0-9a-f]{16}\.data\.parquet$", ".UID.data.parquet", name)


def test_xxh64_matches_the_public_test_vectors():
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert xxh64(b"abc") == 0x44BC2CF5AD770999
    assert xxh64(b"Nobody inspects the spammish repetition") == 0xFBCEA83C8A378BF1
    assert xxh64(b"", seed=1) == 0xD5AFBA1336A3BE4B
    # every tail path (32-byte stripes, 8-, 4- and 1-byte tails) hashes
    # distinctly, and the schema key is the hex of the names' hash
    data = bytes(range(71))
    assert len({xxh64(data[:k]) for k in range(72)}) == 72
    assert get_schema_key(["b", "a"]) == f"{xxh64(b'a' + bytes(1) + b'b'):016x}"


def test_staged_batches_match(both):
    jp, pp, window = both
    js, ps = jp.get_stream(STREAM), pp.get_stream(STREAM)
    jt = pa.Table.from_batches(js.staging_batches())
    pt = pa.Table.from_batches(ps.staging_batches())
    assert pt.schema == jt.schema
    assert "status_str" in pt.column_names
    assert pt.schema.field("created_at").type == pa.timestamp("ms")
    assert pt.schema.field("req_method").type == pa.string()
    assert without_time(pt, window) == without_time(jt, window)
    jnames = sorted(masked(f.name) for f in js.arrow_files())
    pnames = sorted(masked(f.name) for f in ps.arrow_files())
    assert pnames == jnames and pnames
    # the stream schema each committed is the same
    assert pp.metastore.get_schema(STREAM) == jp.metastore.get_schema(STREAM)


@pytest.mark.parametrize("convert", ["local_sync", "prepare_parquet"])
def test_parquet_after_local_sync_matches(both, convert):
    """Staging -> Parquet through the sync tick (all streams, on the sync
    pool) or one stream's `prepare_parquet`, both finishing the current
    minute."""
    jp, pp, window = both
    js, ps = jp.get_stream(STREAM), pp.get_stream(STREAM)
    if convert == "local_sync":
        jp.local_sync(shutdown=True)
        pp.local_sync(shutdown=True)
    else:
        js.prepare_parquet(shutdown=True)
        ps.prepare_parquet(shutdown=True)
    jfiles, pfiles = js.parquet_files(), ps.parquet_files()
    assert not ps.arrow_files() and not js.arrow_files()
    assert sorted(masked(f.name) for f in pfiles) == sorted(masked(f.name) for f in jfiles)
    jt = pa.concat_tables([pq.read_table(f) for f in jfiles])
    pt = pa.concat_tables([pq.read_table(f) for f in pfiles])
    assert pt.schema == jt.schema
    assert without_time(pt, window) == without_time(jt, window)
    codec = {pq.read_metadata(f).row_group(0).column(0).compression for f in jfiles}
    for f in pfiles:
        assert {pq.read_metadata(f).row_group(0).column(0).compression} == codec
        ts = pq.read_table(f, columns=["p_timestamp"]).column(0).to_pylist()
        assert ts == sorted(ts, reverse=True)  # newest first
        # minute-prefix layout: the file's bucket is its rows' minute
        m = re.search(r"date=([0-9-]+)\.hour=(\d\d)\.minute=(\d\d)", f.name)
        assert {(str(t.date()), f"{t.hour:02d}", f"{t.minute:02d}") for t in ts} == {m.groups()}


def test_memory_staging_holds_the_pushed_batches(tmp_path):
    """With P_ENABLE_MEMORY_STAGING both packages keep the batches they
    pushed in the stream's memory writer, the same rows in the same order
    (60 records a batch, 76 rows once the `tags` arrays are expanded)."""
    jp, pp = jax_at(tmp_path, "jax"), port_at(tmp_path, "port")
    jp.options.enable_memory_staging = pp.options.enable_memory_staging = True
    try:
        t0 = datetime.now(UTC).replace(tzinfo=None)
        batches = payloads(11, n=2)
        ingest(jp, jax_flatten, jax_push, JaxLogSource.JSON, batches)
        ingest(pp, flatten_json_records, push_logs, LogSource.JSON, batches)
        window = (t0, datetime.now(UTC).replace(tzinfo=None))
        mem = [p.get_stream(STREAM).writer.mem.snapshot() for p in (jp, pp)]
        assert [b.num_rows for b in mem[1]] == [b.num_rows for b in mem[0]] == [76, 76]
        for jb, pb in zip(*mem):
            assert pb.schema == jb.schema
            assert without_time(pa.Table.from_batches([pb]), window) == without_time(
                pa.Table.from_batches([jb]), window
            )
    finally:
        jp.shutdown()
        pp.shutdown()


def normalized_stream_json(fmt) -> dict:
    doc = fmt.to_json()
    for k in ("created-at", "first-event-at"):
        doc.pop(k, None)
    doc["stats"]["current_stats"].pop("storage")
    doc["stats"]["lifetime_stats"].pop("storage")
    for item in doc["snapshot"]["manifest_list"]:
        for k in ("time_lower_bound", "time_upper_bound", "storage_size"):
            item.pop(k)
    return doc


def normalized_manifest(m) -> list[dict]:
    files = []
    for f in m.to_json()["files"]:
        f.pop("file_size")
        f["file_path"] = masked(f["file_path"].rsplit("/", 1)[-1])
        for c in f["columns"]:
            c.pop("compressed_size")
            c.pop("uncompressed_size")
            if c["name"] == "p_timestamp":
                c.pop("stats")
        files.append(f)
    return sorted(files, key=lambda f: f["file_path"])


def test_stream_json_and_manifests_after_sync_match(both):
    jp, pp, _ = both
    for p in (jp, pp):
        p.local_sync(shutdown=True)
        p.sync_all_streams()
    assert not pp.get_stream(STREAM).parquet_files()
    jfmt, pfmt = jp.metastore.get_stream_json(STREAM), pp.metastore.get_stream_json(STREAM)
    assert normalized_stream_json(pfmt) == normalized_stream_json(jfmt)
    assert pfmt.stats.events == jfmt.stats.events > 0
    jitems, pitems = jfmt.snapshot.manifest_list, pfmt.snapshot.manifest_list
    assert len(pitems) == len(jitems) == 1
    prefix = lambda item: item.manifest_path[: -len("/manifest.json")]  # noqa: E731
    jm = jp.metastore.get_manifest(prefix(jitems[0]))
    pm = pp.metastore.get_manifest(prefix(pitems[0]))
    assert normalized_manifest(pm) == normalized_manifest(jm)
    # object keys follow the same date/hour/minute prefix layout
    layout = re.compile(
        rf"^{STREAM}/date=[0-9-]+/hour=\d\d/minute=\d\d/[A-Za-z0-9_-]+\.[0-9a-f]{{16}}\.data\.parquet$"
    )
    assert all(layout.match(f.file_path) for f in pm.files)


def rows_close(a: pa.Table, b: pa.Table) -> None:
    key = lambda r: json.dumps({k: v for k, v in r.items() if not isinstance(v, float)},  # noqa: E731
                               sort_keys=True, default=str)
    ra, rb = sorted(a.to_pylist(), key=key), sorted(b.to_pylist(), key=key)
    assert len(ra) == len(rb) and ra
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                assert y[k] == pytest.approx(x[k], **TOL), k
            else:
                assert y[k] == x[k], k


def test_each_package_reads_the_lake_the_other_ingested(tmp_path, both):
    jp, pp, _ = both
    for p in (jp, pp):
        p.local_sync(shutdown=True)
        p.sync_all_streams()
    # the port over the JAX package's lake, and the JAX package over the port's
    port_on_jax = Parseable(
        Options(local_staging_path=tmp_path / "r1"), StorageOptions(root=tmp_path / "jax" / "data")
    )
    jopts = JaxOptions()
    jopts.local_staging_path = tmp_path / "r2"
    jax_on_port = JaxParseable(
        jopts, JaxStorageOptions(backend="local-store", root=tmp_path / "port" / "data")
    )
    try:
        for sql in QUERIES:
            ref = JaxSession(jp, engine="cpu").query(sql).table
            gpu = QuerySession(port_on_jax, engine="gpu", device="cpu").query(sql)
            assert gpu.stats["device_routes"]["cpu_fallback"] == 0, sql
            rows_close(ref, gpu.table)
            rows_close(ref, QuerySession(port_on_jax, engine="cpu").query(sql).table)
            rows_close(ref, JaxSession(jax_on_port, engine="cpu").query(sql).table)
    finally:
        port_on_jax.shutdown()
        jax_on_port.shutdown()


def test_query_before_any_sync_sees_staged_rows(both):
    jp, pp, _ = both
    for sql in QUERIES:
        ref = JaxSession(jp, engine="cpu").query(sql, "10m", "now").table
        res = QuerySession(pp, engine="gpu", device="cpu").query(sql, "10m", "now")
        assert res.stats["files_total"] == 0  # nothing in the lake yet
        assert res.stats["staging_rows"] > 0
        assert res.stats["device_routes"]["cpu_fallback"] == 0, sql
        rows_close(ref, res.table)


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
def test_null_group_key_after_a_type_conflict(tmp_path, engine):
    """A string `status` after numeric ones is renamed to `status_str`, so
    those rows group under a null `status` (the JAX package's
    test_query.py::test_schema_evolution_across_files case, where its "tpu"
    engine sometimes counts the null rows under 200)."""
    pp = port_at(tmp_path, "port")
    s = pp.create_stream_if_not_exists(STREAM)
    epochs = [
        [{"status": 200, "msg": "ok"}] * 10,
        [{"status": "timeout", "msg": "bad"}] * 5,
        [{"status": 500, "msg": "err", "retry": 1}] * 3,
    ]
    try:
        for i, rows in enumerate(epochs):
            push_logs(pp, STREAM, rows, LogSource.JSON)
            if i != 1:
                pp.local_sync(shutdown=True)
                pp.sync_all_streams()
        sql = f"SELECT status, count(*) AS c FROM {STREAM} GROUP BY status ORDER BY status"
        device = "cpu" if engine == "gpu" else None
        res = QuerySession(pp, engine=engine, device=device).query(sql)
        assert {r["status"]: r["c"] for r in res.to_json_rows()} == {200.0: 10, 500.0: 3, None: 5}
        files = [f for item in pp.metastore.get_stream_json(STREAM).snapshot.manifest_list
                 for f in pp.metastore.get_manifest(item.manifest_path[: -len("/manifest.json")]).files]
        assert len(files) == 2
    finally:
        pp.shutdown()


def test_orphaned_part_files_are_recovered_on_restart(tmp_path):
    """A `.part.arrows` with a valid footer (a writer closed but never
    renamed) becomes `.arrows` when the stream is loaded again and its rows
    are queryable; a truncated one is discarded. Both packages recover the
    same files from the same staging directory."""
    batches = payloads(3, n=1)
    pp = port_at(tmp_path, "port")
    n = ingest(pp, flatten_json_records, push_logs, LogSource.JSON, batches)
    stream = pp.get_stream(STREAM)
    arrows = stream.staging_batches() and stream.arrow_files()
    assert len(arrows) == 1
    part = arrows[0].with_name(arrows[0].name.replace(".data.arrows", ".data.part.arrows"))
    arrows[0].rename(part)
    garbage = part.with_name("0000000000000000." + part.name.split(".", 1)[1])
    garbage.write_bytes(part.read_bytes()[:100])
    pp.sync_pool.shutdown()
    jax_copy = tmp_path / "jax" / "staging"
    jax_copy.mkdir(parents=True)
    import shutil

    shutil.copytree(tmp_path / "port" / "staging" / STREAM, jax_copy / STREAM)
    shutil.copytree(tmp_path / "port" / "data", tmp_path / "jax" / "data")

    restarted = port_at(tmp_path, "port")
    jp = jax_at(tmp_path, "jax")
    try:
        restarted.load_streams_from_storage()
        jp.load_streams_from_storage()
        names = sorted(f.name for f in restarted.get_stream(STREAM).data_path.iterdir())
        assert names == sorted(f.name for f in jp.get_stream(STREAM).data_path.iterdir())
        assert names == [part.name.replace(".part.arrows", ".arrows")]
        res = QuerySession(restarted, engine="gpu", device="cpu").query(
            f"SELECT count(*) AS c FROM {STREAM}", "10m", "now"
        )
        assert res.table.to_pylist() == [{"c": n}]
    finally:
        restarted.shutdown()
        jp.shutdown()


def test_http_ingest_answers_match_the_jax_app(tmp_path):
    """Both apps take the same ingest requests (valid, bad JSON, nested)
    and answer with the same status and body; the rows they staged answer
    the same query."""
    jopts = JaxOptions()
    jopts.local_staging_path = tmp_path / "jax" / "staging"
    jopts.query_engine = "cpu"
    jstate = jax_app.ServerState(
        JaxParseable(jopts, JaxStorageOptions(backend="local-store", root=tmp_path / "jax" / "data"))
    )
    pstate = port_app.ServerState(port_at(tmp_path, "port"), device="cpu")
    requests = [
        ({"X-P-Stream": STREAM}, json.dumps(payloads(5, n=1)[0]).encode()),
        ({"X-P-Stream": STREAM}, b'[{"a": 1}, {"a": '),
        ({"X-P-Stream": STREAM}, json.dumps({"one": {"nested": [1, 2]}}).encode()),
        ({"X-P-Stream": STREAM, "X-P-Log-Source": "otel-logs"}, b"[]"),
    ]
    query = {"query": f"SELECT host, count(*) AS c FROM {STREAM} GROUP BY host ORDER BY host",
             "startTime": "10m", "endTime": "now"}

    async def drive(state, app_module):
        client = TestClient(TestServer(app_module.build_app(state)))
        await client.start_server()
        try:
            out = []
            for headers, body in requests:
                r = await client.post("/api/v1/ingest", data=body, headers={**AUTH, **headers})
                out.append((r.status, await r.json()))
            r = await client.post("/api/v1/query", json=query, headers=AUTH)
            out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    try:
        jax_out = asyncio.new_event_loop().run_until_complete(drive(jstate, jax_app))
        port_out = asyncio.new_event_loop().run_until_complete(drive(pstate, port_app))
    finally:
        jstate.stop()
        pstate.stop()
    assert [s for s, _ in port_out] == [200, 400, 200, 400, 200]
    # the bad-JSON message quotes the parser's position the same way
    assert port_out == jax_out


# ------------------------------- the statistics slice, with the native hash


@pytest.fixture(scope="module")
def jax_native_hash():
    """The JAX package's native library, whose xxHash64 its approx_distinct
    uses; without it the JAX estimates are blake2b-based and differ from the
    port's by design, so a comparison would test nothing."""
    if native._load() is None:
        pytest.fail("the JAX package's native library did not load: its approx_distinct "
                    "then hashes with blake2b and cannot be compared with the port's xxHash64")
    assert native.xxh64(b"abc") == 0x44BC2CF5AD770999


def test_hll_luts_registers_and_estimates_match_jax(jax_native_hash):
    rng = np.random.default_rng(5)
    dictionary = [f"/api/v1/r{i}" for i in range(3000)] + [17, 2.5, "ü", None]
    pi, pr = PH.luts_for_dictionary(dictionary)
    ji, jr = JH.luts_for_dictionary(dictionary)
    assert np.array_equal(pi, ji) and np.array_equal(pr, jr)
    assert PH.HLL_M == JH.HLL_M
    regs_p, regs_j = [], []
    for n in (10, 300, 5000, 100_000):
        vals = rng.integers(0, n, 4000).tolist()
        a, b = PH.registers_add(None, vals), JH.registers_add(None, vals)
        assert np.array_equal(a, b)
        assert PH.estimate(a) == JH.estimate(b)
        regs_p.append(a)
        regs_j.append(b)
    assert np.array_equal(PH.estimate_many(np.stack(regs_p)), JH.estimate_many(np.stack(regs_j)))
    merged = PH.merge_registers(regs_p[0], regs_p[1])
    assert np.array_equal(merged, JH.merge_registers(regs_j[0], regs_j[1]))
    assert PH.merge_registers(None, None) is None


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_gpu_engine_statistics_match_both_jax_engines(name, tables, jax_native_hash):
    sql = STATS_CASES[name]
    got, routes = port_gpu(sql, tables)
    assert routes["cpu_fallback"] == 0 and routes["device_cold"] == len(tables), routes
    assert_stats(jax_tpu(sql, tables), got, sql, 0)
    assert_stats(jax_cpu(sql, tables), got, sql, 1)


def test_mixed_device_and_fallback_scan_merges_exactly(monkeypatch, tables, jax_native_hash):
    """Once the group space outgrows DENSE_G_MAX the rest of the scan folds
    on the host, in both packages; the device partials (value sets decoded
    through the global dictionary, registers, histograms as sketches, M2 as
    raw moments) merge with the host's."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 4)  # the first block's 2 hosts (+ null) fit
    monkeypatch.setattr(ET, "DENSE_G_MAX", 4)
    sql = (
        "SELECT host AS g0, count(*) AS c0, stddev(bytes) AS s0, approx_median(x) AS p0, "
        "count(distinct path) AS d0, approx_distinct(path) AS d1 FROM t GROUP BY g0"
    )
    got, routes = port_gpu(sql, tables)
    assert routes["device_cold"] == 1 and routes["cpu_fallback"] == 2, routes
    assert_stats(jax_tpu(sql, tables), got, sql, 0)
    assert_stats(jax_cpu(sql, tables), got, sql, 1)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT host AS g0, count(distinct p_timestamp) AS d0 FROM t "
        "WHERE p_timestamp >= '2024-05-01T10:30:00Z' GROUP BY g0",
        "SELECT date_bin(interval '10 minutes', p_timestamp) AS g0, "
        "approx_distinct(p_timestamp) AS d0 FROM t GROUP BY g0",
    ],
    ids=["count-distinct", "approx-distinct"],
)
def test_distinct_over_the_timestamp_column_takes_the_cpu_engine(sql, tables, jax_native_hash):
    """A distinct column is dictionary-encoded; were it the timestamp column,
    time compares and bins would read its codes as ms. The JAX "tpu" engine
    answers these queries wrong (no rows, or one bin at the epoch); the port
    folds such blocks on the host and answers as the CPU engines do."""
    got, routes = port_gpu(sql, tables)
    assert routes["device_cold"] == 0 and routes["cpu_fallback"] == len(tables), routes
    assert_stats(jax_cpu(sql, tables), got, sql, 1)


@pytest.mark.parametrize("n", [300, 900, 5000])  # per-group values below and past 1024
def test_cpu_engine_sketches_match_the_jax_cpu_engine(n, jax_native_hash):
    tables = [stats_table(80 + i, n, 3) for i in range(3)]
    sql = (
        "SELECT host AS g0, approx_percentile_cont(x, 0.9) AS p0, approx_median(lat) AS p1, "
        "approx_distinct(path) AS d0, approx_distinct(bytes) AS d1, stddev(lat) AS s0 "
        "FROM t GROUP BY g0"
    )
    assert port_cpu(sql, tables) == jax_cpu(sql, tables)


# the two dashboard shapes of chip_smoke.py's phase 7, over `stats_table`
# (10-minute bins: a percentile's histogram bound holds for groups of some
# hundred values, as a minute of chip_smoke.py's lake holds)
DASHBOARDS = {
    "stats_status": (
        "SELECT status AS g0, count(*) AS c0, stddev(lat) AS s0, var(bytes) AS s1, "
        "approx_percentile_cont(x, 0.99) AS p0, approx_median(bytes) AS p1 FROM t "
        "WHERE p_timestamp >= '2024-05-01T10:30:00Z' GROUP BY g0"
    ),
    "stats_minute": (
        "SELECT date_bin(interval '10 minutes', p_timestamp) AS g0, status AS g1, "
        "count(distinct path) AS d0, approx_distinct(host) AS d1, "
        "approx_percentile_cont(lat, 0.5) AS p0 FROM t WHERE status >= 400 GROUP BY g0, g1"
    ),
}


@pytest.mark.parametrize("name", list(DASHBOARDS))
def test_dashboard_cache_states_match_both_cpu_engines(name, tables, tmp_path, jax_native_hash):
    """The dashboard shapes over a lake the port wrote, cold, disk-warm and
    device-warm (tests/test_torch_tiering.py's cache states), against the
    JAX CPU engine and the port's CPU engine, and the JAX "tpu" engine."""
    from tests.test_torch_tiering import cache_states, write_lake

    sql = DASHBOARDS[name]
    p = write_lake(tmp_path, tables)
    try:
        ref, dev = jax_cpu(sql, tables), jax_tpu(sql, tables)
        port = QuerySession(p, engine="cpu").query(sql).table.to_pylist()
        assert_stats(ref, port, sql, 1)
        for res in cache_states(p, sql).values():
            got = res.table.to_pylist()
            assert_stats(ref, got, sql, 1)
            assert_stats(port, got, sql, 1)
            assert_stats(dev, got, sql, 0)
    finally:
        p.shutdown()
