"""The port's partial-result cache against the JAX package's, on the CPU.

The cache (`query/partials.py`) keeps the merged interim of an aggregate,
keyed on (stream, manifest-set fingerprint, plan fingerprint); the session
(`query/session.py`) answers a repeated aggregate over an unchanged snapshot
from it. Held here, over lakes the port wrote (tables made from a seed with
numpy):
- a miss, then a hit with an equal table, on both port engines and through
  every aggregate path of the "gpu" engine (`device="cpu"`): dense,
  block-local two-phase, the device top-k and the sketch flush;
- the fingerprints equal the JAX package's on the same manifest files and
  the same statement;
- a sync commit evicts the stream's entries; a query reaching the staging
  window, a scan with errors and an oversized interim are not cached;
- concurrent readers racing a commit get whole tables (the old or the new
  answer), as in tests/test_query_concurrency.py.

Tolerances: a hit's table equals its miss's exactly.
"""

from __future__ import annotations

import threading
from datetime import datetime

import pyarrow as pa
import pytest

from parseable_tpu.query import partials as JP
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.ops import link as PL
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query import partials as PP
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.provider import StreamScan
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from tests.test_torch_executor import make_table

STREAM = "rc"
HIST = {"start_time": "2024-05-01T00:00:00Z", "end_time": "2024-05-02T00:00:00Z"}
ENGINES = ["cpu", "gpu"]
SQL = "SELECT host, count(*) AS c, sum(bytes) AS s, avg(lat) AS l FROM rc GROUP BY host"


@pytest.fixture(autouse=True)
def fresh_state():
    """A fresh process-wide result cache, an empty hot set, and no warmer
    thread left behind."""
    PP._RESULT_CACHE = None
    get_hotset().clear()
    yield
    PL.shutdown_warmer()
    get_hotset().clear()
    PP._RESULT_CACHE = None


def write_minute(p: Parseable, seed: int, minute: int, n: int = 2000, hosts: int = 40) -> None:
    stream = p.create_stream_if_not_exists(STREAM)
    stream.write_parquet(make_table(seed, n, hosts), datetime(2024, 5, 1, 10, minute))
    p.sync_all_streams()


def lake(root, minutes: int = 3, engine: str = "gpu", budget: int | None = None) -> Parseable:
    opts = Options(local_staging_path=root / "staging", query_engine=engine)
    if budget is not None:
        opts.query_result_cache_bytes = budget
    p = Parseable(opts, StorageOptions(root=root / "data"))
    for m in range(minutes):
        write_minute(p, 60 + m, m)
    return p


def run(p: Parseable, engine: str, sql: str = SQL, **time_range):
    return QuerySession(p, engine=engine, device="cpu").query(sql, **time_range)


def total(res) -> int:
    return sum(r["c"] for r in res.table.to_pylist())


@pytest.mark.parametrize("engine", ENGINES)
def test_miss_then_hit_with_an_equal_table(tmp_path, engine):
    p = lake(tmp_path)
    first = run(p, engine, **HIST)
    assert first.stats["stages"]["result_cache"] == "miss"
    assert total(first) == 3 * 2000
    cache = PP.get_result_cache(p.options)
    hits = cache.hits
    again = run(p, engine, **HIST)
    assert again.stats["stages"]["result_cache"] == "hit"
    assert cache.hits == hits + 1
    assert again.stats["bytes_scanned"] == 0 and again.stats["rows_scanned"] == 0
    assert "device_routes" not in again.stats
    assert again.table.equals(first.table)
    # each engine keys its own entry
    other = run(p, "cpu" if engine == "gpu" else "gpu", **HIST)
    assert other.stats["stages"]["result_cache"] == "miss"


# each GPU aggregate path that ends in finalize_from_interim, and what
# steers the query onto it
GPU_PATHS = {
    "dense": ((), SQL),
    "two-phase": (
        ((X, "DENSE_G_MAX", 1 << 4),),
        "SELECT host, path, count(*) AS c, max(lat) AS m FROM rc GROUP BY host, path",
    ),
    "topk": (
        ((X.GpuQueryExecutor, "TOPK_MIN_GROUPS", 1 << 3),),
        "SELECT host, count(*) AS c, sum(bytes) AS s FROM rc GROUP BY host ORDER BY s DESC "
        "LIMIT 5",
    ),
    "sketch-flush": (
        (),
        "SELECT status, count(distinct host) AS c, approx_distinct(path) AS d FROM rc "
        "GROUP BY status HAVING count(*) > 10",
    ),
}


@pytest.mark.parametrize("path", list(GPU_PATHS))
def test_every_gpu_aggregate_path_feeds_the_cache(tmp_path, monkeypatch, path):
    steer, sql = GPU_PATHS[path]
    for target, name, value in steer:
        monkeypatch.setattr(target, name, value)
    p = lake(tmp_path)
    first = run(p, "gpu", sql, **HIST)
    assert first.stats["stages"]["result_cache"] == "miss"
    routes = first.stats["device_routes"]
    # (the upload seeded the encoded-block cache: the prefetcher ships ahead)
    assert routes["device_cold"] + routes["device_warm"] == 3, routes
    assert routes["cpu_fallback"] + routes["cpu_adaptive"] == 0, routes
    if path == "two-phase":
        assert routes["device_local"] > 0, routes
    again = run(p, "gpu", sql, **HIST)
    assert again.stats["stages"]["result_cache"] == "hit"
    assert again.table.equals(first.table)
    assert again.table.num_rows > 0


@pytest.mark.parametrize(
    "sql",
    [
        SQL,
        "SELECT status, count(*) AS c FROM t WHERE p_timestamp >= '2024-05-01T10:01:00Z' "
        "AND p_timestamp < '2024-05-01T11:00:00Z' AND host != 'h1' GROUP BY status "
        "HAVING count(*) > 2 ORDER BY c DESC LIMIT 3",
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, stddev(lat) AS sd FROM t "
        "WHERE message LIKE '%error%' GROUP BY t",
        "SELECT count(*) AS c, max(bytes) AS m FROM t",
    ],
    ids=["groupby", "bounds-having-limit", "date-bin-like", "no-group"],
)
@pytest.mark.parametrize("engine", ["gpu", "cpu", "tpu"])
def test_plan_fingerprint_matches_jax(sql, engine):
    want = JP.plan_fingerprint(jax_plan(jax_parse(sql)), engine)
    assert PP.plan_fingerprint(port_plan(port_parse(sql)), engine) == want


def test_manifest_fingerprint_matches_jax(tmp_path):
    p = lake(tmp_path)
    lp = port_plan(port_parse(SQL))
    files = StreamScan(p, lp).manifest_files()
    assert len(files) == 3
    assert PP.manifest_fingerprint(files) == JP.manifest_fingerprint(files)
    assert PP.manifest_fingerprint(files[:2]) == JP.manifest_fingerprint(files[:2])
    assert PP.manifest_fingerprint(files[:2]) != PP.manifest_fingerprint(files)
    assert PP.manifest_fingerprint(reversed(files)) == PP.manifest_fingerprint(files)


@pytest.mark.parametrize("engine", ENGINES)
def test_a_sync_commit_evicts_the_entry(tmp_path, engine):
    p = lake(tmp_path)
    before = run(p, engine, **HIST)
    assert run(p, engine, **HIST).stats["stages"]["result_cache"] == "hit"
    write_minute(p, 99, 5, n=500)  # update_snapshot evicts the stream's entries
    after = run(p, engine, **HIST)
    assert after.stats["stages"]["result_cache"] == "miss"
    assert total(after) == total(before) + 500


def test_invalidate_drops_only_the_stream():
    cache = PP.get_result_cache(Options())
    t = pa.table({"__g0": [1], "__agg0": [2]})
    cache.put(("a", "m", "p"), t)
    cache.put(("b", "m", "p"), t)
    assert PP.invalidate_result_cache("a") == 1
    assert cache.get(("a", "m", "p")) is None
    assert cache.get(("b", "m", "p")) is t


@pytest.mark.parametrize("engine", ENGINES)
def test_no_caching_inside_the_staging_window(tmp_path, engine):
    p = lake(tmp_path)
    for _ in range(2):
        res = run(p, engine)  # no end bound: the range reaches the staging window
        assert res.stats["stages"]["result_cache"] is None


def test_a_scan_with_errors_is_not_stored(tmp_path):
    p = lake(tmp_path)
    victim = sorted((tmp_path / "data").rglob("*.parquet"))[0]
    victim.unlink()
    for _ in range(2):
        res = run(p, "cpu", **HIST)
        assert res.stats["scan_errors"] == 1
        assert res.stats["stages"]["result_cache"] == "miss"
        assert total(res) == 2 * 2000


def test_an_oversized_interim_is_not_stored(tmp_path):
    p = lake(tmp_path, budget=64)
    for _ in range(2):
        assert run(p, "cpu", **HIST).stats["stages"]["result_cache"] == "miss"
    cache = PP.PartialResultCache(1000)
    small = pa.table({"x": pa.array([1] * 10, pa.int64())})  # 80 bytes
    for i in range(20):
        cache.put(("s", str(i), "p"), small)
    assert cache._bytes <= 1000
    assert cache.get(("s", "0", "p")) is None and cache.get(("s", "19", "p")) is small


def test_a_zero_budget_disables_the_cache(tmp_path):
    p = lake(tmp_path, budget=0)
    assert PP.get_result_cache(p.options) is None
    assert run(p, "cpu", **HIST).stats["stages"]["result_cache"] is None


@pytest.mark.parametrize("engine", ENGINES)
def test_concurrent_readers_get_whole_tables(tmp_path, engine):
    """Readers racing a snapshot commit see the old or the new answer,
    never a mix, never an error; after the commit the new answer is
    served (and cached)."""
    p = lake(tmp_path, minutes=2)
    sql = "SELECT count(*) AS c FROM rc WHERE bytes >= 0"
    old_total = run(p, engine, sql, **HIST).table.to_pylist()[0]["c"]
    results: list = []
    errors: list = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                results.append(run(p, engine, sql, **HIST).table.to_pylist()[0]["c"])
            except Exception as e:  # noqa: BLE001 - the assertion target
                errors.append(repr(e))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    write_minute(p, 77, 4, n=40)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    assert results and set(results) <= {old_total, old_total + 40}
    final = run(p, engine, sql, **HIST)
    assert final.table.to_pylist()[0]["c"] == old_total + 40
    again = run(p, engine, sql, **HIST)
    assert again.stats["stages"]["result_cache"] == "hit"
    assert again.table.equals(final.table)
