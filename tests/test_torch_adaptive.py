"""The port's adaptive host/device gate against the JAX package's, on the CPU.

Module by module, the same inputs (made from a seed with numpy) go through
the JAX package and the port:
- the link profile (`ops/link.py`): the same record sequences give the same
  snapshot, and each package reads the other's file;
- the gate (`_adaptive_gate`): the same route on the same tables, hot-set
  residency, pricing and profile;
then the slice as a whole: the port's "gpu" engine with `device="cpu"` (the
kernels' plain versions) under a slow link, every block or half of them
routed to the host, against the port's CPU engine and the JAX CPU engine,
and the background warmer that ships the routed blocks into the hot set.

Tolerances: routes, counts, keys and snapshots exact; a fully host-routed
answer equals the port's CPU engine exactly (the same partials in the same
order); against the JAX CPU engine, and wherever blocks folded on the
device, floats as in tests/test_torch_executor.py (rel 2e-4, abs 1e-6).
"""

from __future__ import annotations

import json
from datetime import datetime

import numpy as np
import pyarrow as pa
import pytest

from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.ops import link as JL
from parseable_tpu.query import executor_tpu as JX
from parseable_tpu.query.executor import QueryExecutor as JaxCpuExecutor
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.ops import link as PL
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from parseable_tpu_torch.query.stubs import make_stub
from tests.test_torch_executor import assert_rows

ROUTED = 1 << 16  # the gate's routing minimum


@pytest.fixture(autouse=True)
def drained_warmer(monkeypatch):
    """Each test starts with an empty hot set and no encoded-block cache,
    and leaves no warmer thread behind."""
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    get_hotset().clear()
    yield
    PL.shutdown_warmer()
    get_hotset().clear()


# ------------------------------------------------------------- the profile

# (what, bytes or rows, seconds): bandwidth samples (>= 256 KiB), latency
# samples (smaller), host rates at and below the 65,536-row floor, and zero
# times, which are ignored
RECORDS = {
    "slow": [("h2d", 1 << 10, 1.1)] * 20 + [("h2d", 1 << 20, 1.1)] * 20
    + [("d2h", 1 << 20, 1.1)] * 20 + [("agg", 1_000_000, 0.05)] * 5,
    "default": [],
    "fast_host": [("agg", 1_000_000, 0.001)] * 20 + [("filter", 1_000_000, 0.0005)] * 20,
    "fast_link": [("h2d", 1 << 24, 0.0005), ("h2d", 1 << 10, 1e-5)] * 10
    + [("d2h", 1 << 24, 0.0008), ("d2h", 4096, 2e-5)] * 10,
}


def random_records(seed: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(200):
        what = ["h2d", "d2h", "agg", "filter"][int(rng.integers(0, 4))]
        if what in ("h2d", "d2h"):
            n = int(rng.choice([100, 4096, 200_000, 1 << 20, 13 << 20, 1 << 26]))
        else:
            n = int(rng.choice([1000, ROUTED - 1, ROUTED, 1 << 20, 1 << 23]))
        secs = float(rng.choice([0.0, 1e-5, 1e-3, 0.05, 1.1]) * rng.random())
        out.append((what, n, secs))
    return out


def feed(prof, records) -> None:
    rec = {"h2d": prof.record_h2d, "d2h": prof.record_d2h, "agg": prof.record_cpu_agg,
           "filter": prof.record_cpu_filter}
    for what, n, secs in records:
        rec[what](n, secs)


def profiles(records) -> tuple:
    j, p = JL.LinkProfile(), PL.LinkProfile()
    feed(j, records)
    feed(p, records)
    return j, p


@pytest.mark.parametrize("records", [*RECORDS, 1, 2, 3])
def test_link_snapshot_and_estimates_match_jax(records):
    recs = RECORDS[records] if isinstance(records, str) else random_records(records)
    j, p = profiles(recs)
    assert p.snapshot() == j.snapshot()
    assert set(p.snapshot()) == set(JL._DEFAULTS)
    for n in (0, 4096, 1 << 20, 1 << 30):
        assert p.ship_cost(n) == j.ship_cost(n)
        assert p.read_cost(n) == j.read_cost(n)
        assert p.cpu_cost(n) == j.cpu_cost(n)
        assert p.cpu_filter_cost(n) == j.cpu_filter_cost(n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_link_files_load_in_the_other_package(tmp_path, writer):
    """A file written by either package loads in the other with the same
    six values."""
    path = tmp_path / "link_profile.json"
    mod, other = (JL, PL) if writer == "jax" else (PL, JL)
    w = mod.LinkProfile(path)
    feed(w, random_records(7))
    w.flush()
    assert set(json.loads(path.read_text())) == set(JL._DEFAULTS)
    assert other.LinkProfile(path).snapshot() == w.snapshot()


def test_link_flush_bypasses_the_throttle_for_every_rate(tmp_path):
    """A short process persists every rate it learned inside the 5 s
    window (tests/test_adaptive_link.py's flush case, for all six keys)."""
    path = tmp_path / "link_profile.json"
    prof = PL.LinkProfile(path)
    prof.record_h2d(1 << 20, 1.0)  # the first save stamps the throttle
    feed(prof, RECORDS["slow"] + RECORDS["fast_host"])
    prof.flush()
    stored = json.loads(path.read_text())
    assert stored == prof.snapshot()
    assert stored["h2d_bw"] < 8e9 * 0.6 and stored["d2h_bw"] < 8e9 * 0.6
    assert stored["cpu_rows_per_sec"] != 2e7 and stored["cpu_filter_rows_per_sec"] != 4e7


def test_link_merge_on_save_keeps_the_other_process_d2h(tmp_path):
    """tests/test_adaptive_link.py's merge case: the process that learned
    only d2h does not reset the other's h2d learning, and its own d2h
    measurement persists."""
    path = tmp_path / "link_profile.json"
    a, b = PL.LinkProfile(path), PL.LinkProfile(path)
    for _ in range(30):
        a.record_h2d(1 << 22, 4.0)  # ~1 MB/s: a learns a terrible link
    a.flush()
    a_bw = json.loads(path.read_text())["h2d_bw"]
    assert a_bw < 1e8
    b.record_d2h(1 << 22, 2.0)
    b.flush()
    stored = json.loads(path.read_text())
    assert stored["h2d_bw"] <= 0.5 * (a_bw + 8e9) + 1e-6
    assert stored["h2d_bw"] < 8e9 * 0.6
    assert stored["d2h_bw"] < 8e9


def test_host_rates_ignore_blocks_under_the_routing_floor():
    p = PL.LinkProfile()
    p.record_cpu_agg(ROUTED - 1, 1e-6)
    p.record_cpu_filter(ROUTED - 1, 1e-6)
    assert p.snapshot() == PL.LinkProfile().snapshot()
    p.record_cpu_agg(ROUTED, 1.0)
    assert p.snapshot()["cpu_rows_per_sec"] == 0.7 * 2e7 + 0.3 * ROUTED


def test_pin_link_overrides_every_caller_and_does_not_nest(tmp_path):
    from parseable_tpu_torch.config import Options

    prof = PL.LinkProfile()
    with PL.pin_link(prof):
        assert PL.get_link() is prof
        assert PL.get_link(Options(local_staging_path=tmp_path)) is prof
        with pytest.raises(RuntimeError):
            with PL.pin_link(PL.LinkProfile()):
                pass
    assert PL.get_link() is not prof
    assert not (tmp_path / "link_profile.json").exists()


# ---------------------------------------------------------------- the gate

GATE_SQL = "SELECT k, count(*) AS c, sum(v) AS s, max(v) AS m FROM t GROUP BY k"
NEEDED = {"k", "v"}
DICT_COLS = {"k"}


class _Hot:
    def __init__(self, resident: bool):
        self.resident = resident

    def contains(self, key) -> bool:
        return self.resident


@pytest.fixture(scope="module")
def gates():
    """Both executors and each one's local-mode readback price (its own
    accumulator layout and LOCAL_G_MAX)."""
    opts = JaxOptions()
    opts.mesh_shape = "off"
    jx = JX.TpuQueryExecutor(jax_plan(jax_parse(GATE_SQL)), opts)
    px = X.GpuQueryExecutor(port_plan(port_parse(GATE_SQL)), device="cpu")
    j_rows = JX.AccLayout.from_specs(jx.build_aggregator()[0].specs).n_rows
    p_rows = X.AccLayout.from_specs(px.build_aggregator()[0].specs).n_rows
    assert j_rows == p_rows and JX.LOCAL_G_MAX == X.LOCAL_G_MAX
    return jx, px, j_rows


def gate_table(rows: int, kind: str) -> pa.Table:
    if kind == "stub":
        return make_stub(b"gate-src", rows)
    return pa.table({"v": np.zeros(rows, np.float32)}).replace_schema_metadata(
        {X.SOURCE_ID_META: b"gate-src"})


@pytest.mark.parametrize("profile", list(RECORDS))
@pytest.mark.parametrize("pricing", ["select", "dense", "local"])
@pytest.mark.parametrize("resident", [False, True], ids=["cold", "resident"])
@pytest.mark.parametrize("rows,kind", [(ROUTED - 1, "real"), (ROUTED, "real"), (ROUTED, "stub"),
                                       (1 << 17, "stub")])
def test_gate_decides_as_jax(gates, rows, kind, resident, pricing, profile):
    jx, px, n_acc_rows = gates
    j_link, p_link = profiles(RECORDS[profile])
    reads = {
        "select": lambda r: r,
        "dense": lambda r: 0,
        "local": lambda r: min(r, X.LOCAL_G_MAX) * n_acc_rows * 4,
    }
    table = gate_table(rows, kind)
    args = (NEEDED, DICT_COLS)
    kw = {"filter_workload": pricing == "select"}
    want = jx._adaptive_gate(table, *args, j_link, _Hot(resident), reads[pricing], **kw)
    got = px._adaptive_gate(table, *args, p_link, _Hot(resident), reads[pricing], **kw)
    assert got == want
    if rows < ROUTED or resident:
        assert got[0] is False


def test_gate_routes_on_the_slow_link_and_keeps_the_default_dense_block():
    """The decisions the parametrised case holds against JAX are not all
    one way: a slow link routes, the optimistic default keeps a dense
    block on the device and routes a local-mode 65,536-row block (its
    readback tips it)."""
    px = X.GpuQueryExecutor(port_plan(port_parse(GATE_SQL)), device="cpu")
    t = gate_table(ROUTED, "stub")
    slow, default = profiles(RECORDS["slow"])[1], PL.LinkProfile()
    local = lambda r: min(r, X.LOCAL_G_MAX) * 4 * 4  # noqa: E731
    assert px._adaptive_gate(t, NEEDED, DICT_COLS, slow, _Hot(False), lambda r: 0)[0]
    assert not px._adaptive_gate(t, NEEDED, DICT_COLS, default, _Hot(False), lambda r: 0)[0]
    assert px._adaptive_gate(t, NEEDED, DICT_COLS, default, _Hot(False), local)[0]


# ------------------------------------------------------- the slice, routed

BASE = datetime(2024, 5, 1, 10, 0)
N_BLOCKS = 4


def block_table(seed: int, n: int = ROUTED) -> pa.Table:
    rng = np.random.default_rng(seed)
    ms = np.datetime64(BASE, "ms") + rng.integers(0, 2 * 3600 * 1000, n).astype("timedelta64[ms]")
    lat = rng.random(n) * 100
    return pa.table(
        {
            "p_timestamp": pa.array(ms, pa.timestamp("ms")),
            "host": pa.array(np.char.add("h", rng.integers(0, 3000, n).astype(str))),
            "path": pa.array(np.char.add("/p", rng.integers(0, 40, n).astype(str))),
            "status": pa.array(rng.choice([200.0, 301.0, 404.0, 500.0], n)),
            "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
            "lat": pa.array(lat, mask=rng.random(n) < 0.1),
        }
    )


@pytest.fixture(scope="module")
def blocks() -> list[pa.Table]:
    """Lake-like blocks of 65,536 rows, each with a source id (so each
    stays a block of its own)."""
    return [
        block_table(70 + i).replace_schema_metadata({X.SOURCE_ID_META: f"ad{i}".encode()})
        for i in range(N_BLOCKS)
    ]


ROUTED_CASES = {
    "dense": (
        "SELECT status AS g0, count(*) AS c0, sum(bytes) AS a0, avg(lat) AS a1, "
        "min(bytes) AS m0, max(lat) AS m1 FROM t WHERE p_timestamp >= '2024-05-01T10:30:00Z' "
        "GROUP BY g0"
    ),
    # 3,000 hosts x 40 paths pass the (lowered) dense budget: block-local
    "local": (
        "SELECT host AS g0, path AS g1, count(*) AS c0, sum(bytes) AS a0, max(lat) AS m0 "
        "FROM t GROUP BY g0, g1"
    ),
    "stddev-var": (
        "SELECT path AS g0, count(*) AS c0, stddev(lat) AS a0, var(bytes) AS a1 FROM t "
        "GROUP BY g0"
    ),
    # not partializable: host-routed blocks fold into the host aggregator
    "percentile": (
        "SELECT status AS g0, approx_percentile_cont(lat, 0.5) AS a0, count(*) AS c0 "
        "FROM t GROUP BY g0"
    ),
    "select": "SELECT host, path, bytes FROM t WHERE status = 404 AND lat < 20.0",
}


def slow_link() -> PL.LinkProfile:
    return profiles(RECORDS["slow"])[1]


def port_gpu(sql: str, tables) -> tuple[list[dict], dict]:
    ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
    return ex.execute(iter(tables)).to_pylist(), ex.route_stats


def port_cpu(sql: str, tables) -> list[dict]:
    return PortCpuExecutor(port_plan(port_parse(sql))).execute(iter(tables)).to_pylist()


def jax_cpu(sql: str, tables) -> list[dict]:
    return JaxCpuExecutor(jax_plan(jax_parse(sql))).execute(iter(tables)).to_pylist()


def rows_key(r: dict) -> tuple:
    return tuple(str(r[k]) for k in sorted(r))


@pytest.fixture()
def small_dense_budget(monkeypatch):
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 10)


@pytest.mark.parametrize("name", list(ROUTED_CASES))
def test_every_block_host_routed_equals_the_cpu_engines(name, blocks, small_dense_budget):
    sql = ROUTED_CASES[name]
    before = X.ADAPTIVE_CPU_BLOCKS[0]
    with PL.pin_link(slow_link()):
        got, routes = port_gpu(sql, blocks)
        cpu = port_cpu(sql, blocks)
    assert routes["cpu_adaptive"] == N_BLOCKS, routes
    assert routes["device_warm"] + routes["device_cold"] + routes["cpu_fallback"] == 0, routes
    assert X.ADAPTIVE_CPU_BLOCKS[0] == before + N_BLOCKS
    assert sorted(got, key=rows_key) == sorted(cpu, key=rows_key)
    if name == "select":
        assert sorted(got, key=rows_key) == sorted(jax_cpu(sql, blocks), key=rows_key)
    else:
        assert_rows(jax_cpu(sql, blocks), got, sql, exact_minmax=False)


def test_count_distinct_is_never_routed(blocks):
    sql = "SELECT status AS g0, count(distinct path) AS c0 FROM t GROUP BY g0"
    with PL.pin_link(slow_link()):
        got, routes = port_gpu(sql, blocks)
    assert routes["cpu_adaptive"] == 0 and routes["device_cold"] == N_BLOCKS, routes
    assert_rows(port_cpu(sql, blocks), got, sql, exact_minmax=False)


@pytest.mark.parametrize("name", ["dense", "local", "stddev-var", "select"])
@pytest.mark.parametrize("first", ["device", "host"])
def test_mixed_routing_equals_the_cpu_engine(name, first, blocks, small_dense_budget):
    """Half the blocks resident (they take the device), half routed to the
    host, interleaved: the device accumulator (or the block-local
    partials) and the host partials merge into the CPU engine's answer."""
    sql = ROUTED_CASES[name]
    resident = [b for i, b in enumerate(blocks) if (i % 2 == 0) == (first == "device")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P_TPU_ADAPTIVE", "0")
        port_gpu(sql, resident)  # the hot set now holds these blocks
    with PL.pin_link(slow_link()):
        got, routes = port_gpu(sql, blocks)
    half = N_BLOCKS // 2
    assert (routes["device_warm"], routes["cpu_adaptive"], routes["cpu_fallback"]) == (
        half, half, 0), routes
    if name == "local":
        assert routes["device_local"] == half, routes
    cpu = port_cpu(sql, blocks)
    if name == "select":
        assert sorted(got, key=rows_key) == sorted(cpu, key=rows_key)
    else:
        assert_rows(cpu, got, sql, exact_minmax=False)


@pytest.mark.parametrize("name", ["dense", "select"])
def test_routed_blocks_are_warmed_into_the_hot_set(name, blocks):
    """The warmer ships every routed block behind the query; the next
    query, on any profile, finds them all resident."""
    sql = ROUTED_CASES[name]
    with PL.pin_link(slow_link()):
        first, routes = port_gpu(sql, blocks)
    assert routes["cpu_adaptive"] == N_BLOCKS, routes
    PL.shutdown_warmer()  # drains the queued warms
    assert get_hotset().stats_snapshot()["entries"] == N_BLOCKS
    with PL.pin_link(slow_link()):
        again, routes = port_gpu(sql, blocks)
    assert (routes["device_warm"], routes["cpu_adaptive"]) == (N_BLOCKS, 0), routes
    if name == "select":
        assert sorted(again, key=rows_key) == sorted(first, key=rows_key)
    else:
        assert_rows(first, again, sql, exact_minmax=False)


def test_a_routed_stub_is_warmed_from_its_source(blocks):
    """A routed stub folds on the rows its source loader reads, and the
    warmer encodes those rows for the hot set."""
    sql = ROUTED_CASES["dense"]
    sources = {f"ad{i}".encode(): b for i, b in enumerate(blocks)}
    stubs = [make_stub(s, b.num_rows) for s, b in sources.items()]
    ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
    ex.source_loader = sources.__getitem__
    with PL.pin_link(slow_link()):
        got = ex.execute(iter(stubs)).to_pylist()
    assert ex.route_stats["cpu_adaptive"] == N_BLOCKS, ex.route_stats
    assert sorted(got, key=rows_key) == sorted(port_cpu(sql, blocks), key=rows_key)
    PL.shutdown_warmer()
    assert get_hotset().stats_snapshot()["entries"] == N_BLOCKS


def test_adaptive_off_routes_nothing(blocks, monkeypatch):
    monkeypatch.setenv("P_TPU_ADAPTIVE", "0")
    before = X.ADAPTIVE_CPU_BLOCKS[0]
    with PL.pin_link(slow_link()):
        for sql in (ROUTED_CASES["dense"], ROUTED_CASES["select"]):
            _, routes = port_gpu(sql, blocks)
            assert routes["cpu_adaptive"] == 0 and routes["device_cold"] == N_BLOCKS, routes
    assert X.ADAPTIVE_CPU_BLOCKS[0] == before


class _Spy(PL.LinkProfile):
    """A slow-link profile that keeps the row counts of its host records."""

    def __init__(self):
        super().__init__()
        self.agg_rows: list[int] = []
        self.filter_rows: list[int] = []
        feed(self, RECORDS["slow"])
        self.agg_rows.clear()

    def record_cpu_agg(self, rows, secs):
        self.agg_rows.append(rows)
        super().record_cpu_agg(rows, secs)

    def record_cpu_filter(self, rows, secs):
        self.filter_rows.append(rows)
        super().record_cpu_filter(rows, secs)


def test_host_rate_is_recorded_on_pre_bounds_rows(blocks, monkeypatch):
    """Both port engines record the host rate on each block's rows before
    the time bounds filter, the basis the gate prices on. The JAX CPU
    engine counts them after the filter (its query/executor.py:1202-1203,
    against its own comment): a difference by design, pinned here."""
    sql = ROUTED_CASES["dense"]  # its WHERE bounds p_timestamp: ~3/4 of the rows pass
    spy = _Spy()
    with PL.pin_link(spy):
        port_gpu(sql, blocks)
        assert spy.agg_rows == [ROUTED] * N_BLOCKS
        spy.agg_rows.clear()
        port_cpu(sql, blocks)
        assert spy.agg_rows == [ROUTED] * N_BLOCKS
        port_gpu(ROUTED_CASES["select"], blocks)
        assert spy.filter_rows == [ROUTED] * N_BLOCKS
    jax_spy = JL.LinkProfile()
    seen: list[int] = []
    monkeypatch.setattr(jax_spy, "record_cpu_agg", lambda rows, secs: seen.append(rows))
    monkeypatch.setattr(JL, "get_link", lambda options=None: jax_spy)
    jax_cpu(sql, blocks)
    assert len(seen) == N_BLOCKS and all(0 < n < ROUTED for n in seen), seen


def test_an_executor_without_options_leaves_the_link_profile_where_it_is(
        tmp_path, monkeypatch, blocks):
    """A GPU executor built without options that hands its aggregate to the
    CPU engine (an aggregate over an expression is refused at plan time)
    records the host rate into the process-wide profile where it is: it
    neither re-roots the profile in the default staging dir nor writes
    there."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "staging").mkdir()
    monkeypatch.setattr(PL, "_GLOBAL", None)
    monkeypatch.setattr(PL, "_GLOBAL_PATH", None)
    prof = PL.get_link()
    _, routes = port_gpu("SELECT host AS g0, sum(lat * 2) AS a0 FROM t GROUP BY g0", blocks)
    assert routes["cpu_fallback"] == 1, routes
    assert PL.get_link() is prof and PL._GLOBAL_PATH is None
    assert prof.snapshot()["cpu_rows_per_sec"] != PL.LinkProfile().snapshot()["cpu_rows_per_sec"]
    prof.flush()
    assert not (tmp_path / "staging" / "link_profile.json").exists()
