"""The port's GPU executor against the JAX package's engines, on the CPU.

The same pyarrow tables go through
- `parseable_tpu_torch` `GpuQueryExecutor(device="cpu")` — the port's dense
  device path, with its kernels' plain versions on CPU tensors;
- the JAX `TpuQueryExecutor` on CPU JAX;
- the JAX CPU `QueryExecutor`;
- the port's CPU `QueryExecutor` (its oracle engine).

Tolerances follow tests/test_engine_fuzz.py's model, chosen per column by
its alias prefix:
- `c*` counts: exact (f32 adds of 0/1, exact below 2^24);
- `a*` sums and averages: rel 2e-4, abs 1e-6 (f32 per-block sums against
  f64 and against another f32 summation order);
- `m*` min/max: exact against the JAX TPU engine (both pick the same f32
  value), rel 2e-4 against the f64 CPU engines (f32 rounding of the value).
Row identity sorts on group keys only (`g*`), never on floats.
"""

import random
from datetime import datetime, timedelta

import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import chip_smoke
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.query.executor import QueryExecutor as JaxCpuExecutor
from parseable_tpu.query.executor_tpu import TpuQueryExecutor
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse

BASE = datetime(2024, 5, 1, 10, 0)
TOL = dict(rel=2e-4, abs=1e-6)
HOST_CARDS = (2, 5, 40)  # per table: the group dictionary grows across blocks


def make_table(seed: int, n: int, n_hosts: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    ms = rng.integers(0, 2 * 3600 * 1000, n)  # two hours, ms resolution
    lat = rng.random(n) * 100
    null = rng.random(n) < 0.1
    return pa.table(
        {
            "p_timestamp": pa.array(
                [BASE + timedelta(milliseconds=int(v)) for v in ms], pa.timestamp("ms")
            ),
            "host": pa.array(rng.choice([f"h{i}" for i in range(n_hosts)], n).tolist()),
            "path": pa.array(rng.choice([f"/p{i}" for i in range(12)], n).tolist()),
            "message": pa.array(
                rng.choice(["ok", "error: timeout", "slow", "error: denied"], n).tolist()
            ),
            "status": pa.array(rng.choice([200.0, 301.0, 404.0, 500.0], n)),
            "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
            "lat": pa.array([None if z else float(v) for z, v in zip(null, lat)]),
        }
    )


@pytest.fixture(scope="module")
def tables() -> list[pa.Table]:
    return [make_table(40 + i, 3000, card) for i, card in enumerate(HOST_CARDS)]


def port_gpu(sql: str, tables) -> tuple[list[dict], dict]:
    """The port's GPU path; each table carries a source id, as scanned
    Parquet does, so each stays a device block of its own. The ids are
    made up (t0, t1, ...) and name other tables in other calls, so the
    process-wide hot set starts empty for each call and the encoded-block
    cache is off."""
    get_hotset().clear()
    blocks = [
        t.replace_schema_metadata({X.SOURCE_ID_META: f"t{i}".encode()})
        for i, t in enumerate(tables)
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P_TPU_ENC_CACHE", "0")
        ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
        return ex.execute(iter(blocks)).to_pylist(), ex.route_stats


def jax_tpu(sql: str, tables) -> list[dict]:
    opts = JaxOptions()
    opts.mesh_shape = "off"
    return TpuQueryExecutor(jax_plan(jax_parse(sql)), opts).execute(iter(tables)).to_pylist()


def jax_cpu(sql: str, tables) -> list[dict]:
    return JaxCpuExecutor(jax_plan(jax_parse(sql))).execute(iter(tables)).to_pylist()


def port_cpu(sql: str, tables) -> list[dict]:
    return PortCpuExecutor(port_plan(port_parse(sql))).execute(iter(tables)).to_pylist()


def assert_rows(ref: list[dict], got: list[dict], sql: str, exact_minmax: bool, ordered=False):
    def key(r):
        return tuple(str(r[k]) for k in sorted(r) if k.startswith("g"))

    if not ordered:
        ref, got = sorted(ref, key=key), sorted(got, key=key)
    assert len(ref) == len(got), (sql, len(ref), len(got))
    for rr, rg in zip(ref, got):
        assert set(rr) == set(rg), sql
        for k, a in rr.items():
            b = rg[k]
            if k.startswith("m") and exact_minmax:
                assert a == b, (sql, k, a, b)
            elif isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, **TOL), (sql, k, a, b)
            else:
                assert a == b, (sql, k, a, b)


CASES = {
    # BASELINE config 2: time-bucketed GROUP BY
    "config2": (
        "SELECT date_bin(interval '1 minute', p_timestamp) AS g0, status AS g1, "
        "count(*) AS c0, sum(bytes) AS a0, avg(lat) AS a1 FROM t GROUP BY g0, g1"
    ),
    # BASELINE config 3: LIKE over the dictionary
    "config3": (
        "SELECT status AS g0, count(*) AS c0, avg(lat) AS a0 FROM t "
        "WHERE message LIKE '%error%' GROUP BY g0"
    ),
    # BASELINE config 4: multi-column group, ORDER BY/LIMIT on the host
    "config4": (
        "SELECT path AS g0, host AS g1, count(*) AS c0, sum(bytes) AS a0 FROM t "
        "GROUP BY g0, g1 ORDER BY a0 DESC LIMIT 10"
    ),
    "minmax": (
        "SELECT host AS g0, min(lat) AS m0, max(bytes) AS m1, count(lat) AS c0 FROM t "
        "WHERE status >= 400 AND p_timestamp >= '2024-05-01T10:30:00Z' GROUP BY g0"
    ),
    "str-eq": "SELECT path AS g0, count(*) AS c0 FROM t WHERE host = 'h1' GROUP BY g0",
    "str-ne": "SELECT path AS g0, count(*) AS c0 FROM t WHERE host != 'h0' GROUP BY g0",
    "str-in": (
        "SELECT host AS g0, sum(lat) AS a0 FROM t WHERE host IN ('h0', 'h3', 'h9') GROUP BY g0"
    ),
    "str-not-like": (
        "SELECT status AS g0, count(*) AS c0 FROM t WHERE message NOT LIKE 'error%' GROUP BY g0"
    ),
    "num-cmp": (
        "SELECT status AS g0, count(*) AS c0, max(lat) AS m0 FROM t "
        "WHERE lat < 33.3 AND status != 301 GROUP BY g0"
    ),
    "num-in": "SELECT path AS g0, count(*) AS c0 FROM t WHERE status IN (200, 404) GROUP BY g0",
    "null-and-not": (
        "SELECT host AS g0, count(*) AS c0 FROM t WHERE lat IS NOT NULL "
        "AND NOT (path = '/p1') GROUP BY g0"
    ),
    "subsecond-bounds": (
        "SELECT host AS g0, count(*) AS c0, sum(bytes) AS a0 FROM t "
        "WHERE p_timestamp > '2024-05-01T10:30:00.250Z' "
        "AND p_timestamp <= '2024-05-01T11:15:30.500Z' GROUP BY g0"
    ),
    "time-eq": "SELECT count(*) AS c0 FROM t WHERE p_timestamp >= '2024-05-01T11:00:00.001Z'",
    # bins start mid-day, so the block's bin offset is negative (floor division)
    "date-bin-10m": (
        "SELECT date_bin(interval '10 minutes', p_timestamp) AS g0, count(*) AS c0, "
        "min(lat) AS m0 FROM t GROUP BY g0"
    ),
    # a 7-day bin is not day-aligned: the origin shift is nonzero
    "date-bin-7d": (
        "SELECT date_bin(interval '7 days', p_timestamp) AS g0, host AS g1, count(*) AS c0 "
        "FROM t GROUP BY g0, g1"
    ),
    "date-trunc": (
        "SELECT date_trunc('minute', p_timestamp) AS g0, count(*) AS c0 FROM t "
        "WHERE path LIKE '/p1%' GROUP BY g0 HAVING count(*) > 2"
    ),
    "no-group": "SELECT count(*) AS c0, sum(bytes) AS a0, min(bytes) AS m0 FROM t",
    # stddev/var (kernel K7) and count(distinct) (kernel K5) on the device;
    # tests/test_torch_stats.py holds the rest of the statistics
    "stddev": "SELECT host AS g0, stddev(lat) AS a0 FROM t GROUP BY g0",
    "distinct": "SELECT host AS g0, count(distinct path) AS c0 FROM t GROUP BY g0",
    "empty-match": "SELECT host AS g0, count(*) AS c0 FROM t WHERE host = 'nope' GROUP BY g0",
}


@pytest.mark.parametrize("name", list(CASES))
def test_executor_matches_jax_engines(name, tables):
    sql = CASES[name]
    got, routes = port_gpu(sql, tables)
    assert routes["cpu_fallback"] == 0, routes
    assert routes["device_cold"] == len(tables)
    ordered = "ORDER BY" in sql
    assert_rows(jax_tpu(sql, tables), got, sql, exact_minmax=True, ordered=ordered)
    assert_rows(jax_cpu(sql, tables), got, sql, exact_minmax=False, ordered=ordered)
    assert_rows(jax_cpu(sql, tables), port_cpu(sql, tables), sql, False, ordered=ordered)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT host AS g0, stddev(lat * 2) AS a0 FROM t GROUP BY g0",
        "SELECT host AS g0, approx_percentile_cont(lat + 1, 0.5) AS a0 FROM t GROUP BY g0",
        "SELECT host AS g0, sum(lat * 2) AS a0 FROM t GROUP BY g0",
        # a WHERE the K3 program cannot express: each block filters on the host
        "SELECT host AS g0, path AS g1 FROM t WHERE lower(host) = 'h0' ORDER BY g0, g1 LIMIT 5",
    ],
    ids=["stddev-over-expr", "percentile-over-expr", "agg-over-expr", "select"],
)
def test_outside_the_slice_takes_the_cpu_engine(sql, tables):
    """An aggregate the device cannot fold is refused once, at plan time; a
    select's WHERE is lowered per block, so each block counts."""
    got, routes = port_gpu(sql, tables)
    fallbacks = 1 if "GROUP BY" in sql else len(tables)
    assert routes["cpu_fallback"] == fallbacks and routes["device_cold"] == 0, routes
    assert_rows(jax_cpu(sql, tables), got, sql, exact_minmax=False, ordered="LIMIT" in sql)


def test_group_space_beyond_the_dense_budget(monkeypatch, tables):
    """Once the group space outgrows DENSE_G_MAX the rest of the scan folds
    block-local on the device, as in the JAX package: the first block's
    dense epoch (4 x 16 groups) and the local blocks' partials merge
    exactly, and no block folds on the host."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 64)
    sql = "SELECT host AS g0, path AS g1, count(*) AS c0, max(lat) AS m0 FROM t GROUP BY g0, g1"
    got, routes = port_gpu(sql, tables)
    assert (routes["device_cold"], routes["device_local"], routes["cpu_fallback"]) == (3, 2, 0), routes
    assert_rows(jax_cpu(sql, tables), got, sql, exact_minmax=False)


# ------------------------------------------------- bounded differential fuzz


AGGS = [
    ("c", "count(*)"), ("c", "count(lat)"), ("a", "sum(lat)"), ("a", "avg(lat)"),
    ("m", "min(lat)"), ("m", "max(lat)"), ("a", "sum(status)"), ("m", "max(bytes)"),
]
GROUPS = [
    "host", "path", "status", "date_bin(interval '10m', p_timestamp)",
    "date_trunc('minute', p_timestamp)",
]
FILTERS = [
    "status >= 400", "status = 200", "lat > 50", "lat IS NOT NULL",
    "host != 'h0'", "host IN ('h0', 'h1')", "path LIKE '/p1%'",
    "status >= 300 AND lat < 80", "status = 500 OR status = 404",
    "p_timestamp >= '2024-05-01T10:30:00Z'",
    "p_timestamp > '2024-05-01T10:30:00.250Z'",
    "p_timestamp <= '2024-05-01T10:45:30.500Z'",
    "NOT (host = 'h1')", "message LIKE '%error%'",
]
HAVINGS = ["count(*) > 2", "count(*) >= 10", "count(lat) > 3"]
FUZZ_TRIALS = 40


def gen_query(rng: random.Random) -> tuple[str, bool]:
    """A query and whether the device path must decline it: a numeric
    aggregate over a GROUP BY column (that column encodes as dictionary
    codes), which the JAX engine declines the same way."""
    picks = rng.sample(AGGS, rng.randint(1, 3))
    aggs = [f"{expr} {kind}{i}" for i, (kind, expr) in enumerate(picks)]
    groups = rng.sample(GROUPS, rng.randint(0, 2))
    sql = "SELECT " + ", ".join([f"{g} g{i}" for i, g in enumerate(groups)] + aggs) + " FROM t"
    if rng.random() < 0.7:
        sql += f" WHERE {rng.choice(FILTERS)}"
    if groups:
        sql += " GROUP BY " + ", ".join(f"g{i}" for i in range(len(groups)))
        if rng.random() < 0.3:
            sql += f" HAVING {rng.choice(HAVINGS)}"
    declined = any(
        f"{fn}({g})" in sql for g in groups for fn in ("sum", "avg", "min", "max")
    )
    return sql, declined


def test_differential_fuzz():
    """Port GPU path vs JAX CPU engine vs port CPU engine, seed-pinned."""
    rng = random.Random(1234)
    for trial in range(FUZZ_TRIALS):
        tables = [
            make_table(rng.randrange(1 << 30), rng.choice([500, 2000]), rng.choice([2, 5, 40]))
            for _ in range(rng.randint(1, 3))
        ]
        sql, declined = gen_query(rng)
        got, routes = port_gpu(sql, tables)
        assert (routes["cpu_fallback"] > 0) == declined, (trial, sql, routes)
        ref = jax_cpu(sql, tables)
        assert_rows(ref, got, f"[trial {trial}] {sql}", exact_minmax=False)
        assert_rows(ref, port_cpu(sql, tables), f"[trial {trial}] {sql}", exact_minmax=False)


# ------------------------------------------------ NULL keys, negations, NaN


def with_null_hosts(table: pa.Table, seed: int) -> pa.Table:
    """`table` with exactly 5% of its host values set to NULL."""
    n = table.num_rows
    null = np.zeros(n, dtype=bool)
    null[np.random.default_rng(seed).choice(n, n // 20, replace=False)] = True
    host = pc.if_else(pa.array(null), pa.scalar(None, pa.string()), table["host"].combine_chunks())
    return table.set_column(table.schema.get_field_index("host"), "host", host)


@pytest.fixture(scope="module")
def null_host_tables() -> list[pa.Table]:
    """The three tables of `tables`, 450 NULL hosts and 914 NULL lat values."""
    return [with_null_hosts(make_table(40 + i, 3000, card), 47 + i)
            for i, card in enumerate(HOST_CARDS)]


# (blocks, query): the second block's 5 hosts grow the host dictionary past
# code 3, the first capacity epoch's null slot (capacity 4: 2 hosts + null)
EPOCH_CASES = {
    "count": (2, "SELECT host AS g0, count(*) AS c0 FROM t GROUP BY g0"),
    "stddev": (3, "SELECT host AS g0, stddev(lat) AS a0 FROM t WHERE lat > 99.5 GROUP BY g0"),
}


@pytest.mark.parametrize("name", list(EPOCH_CASES))
def test_null_group_key_survives_a_capacity_epoch(name, null_host_tables):
    """A block whose dictionary outgrows the key's capacity ends an epoch:
    its accumulators are decoded with the dictionary that already holds the
    new block's values, and the old epoch's null slot must still decode as
    NULL. Held against both CPU engines: the JAX "tpu" engine relabels the
    null slot the same way on blocks tagged by source id."""
    blocks, sql = EPOCH_CASES[name]
    tables = null_host_tables[:blocks]
    got, routes = port_gpu(sql, tables)
    assert routes["cpu_fallback"] == 0 and routes["device_cold"] == blocks, routes
    assert any(r["g0"] is None for r in got)
    assert_rows(jax_cpu(sql, tables), got, sql, exact_minmax=False)
    assert_rows(port_cpu(sql, tables), got, sql, exact_minmax=False)
    if name == "count":
        counts = {r["g0"]: r["c0"] for r in got}
        assert (counts[None], counts["h4"]) == (300, 584)
    else:
        assert len(got) == 20


def _in_h0_h1(col):
    return pc.or_kleene(pc.equal(col, "h0"), pc.equal(col, "h1"))


# WHERE clause -> its value per row under SQL's three-valued logic (NULL
# where an operand is NULL), built from pyarrow's Kleene kernels
NEGATIONS = {
    "not-eq": ("NOT (host = 'h0')", lambda t: pc.invert(pc.equal(t["host"], "h0"))),
    "not-in": ("host NOT IN ('h0', 'h1')", lambda t: pc.invert(_in_h0_h1(t["host"]))),
    "not-of-in": ("NOT (host IN ('h0', 'h1'))", lambda t: pc.invert(_in_h0_h1(t["host"]))),
    "not-between": (
        "lat NOT BETWEEN 10 AND 20",
        lambda t: pc.invert(pc.and_kleene(pc.greater_equal(t["lat"], 10.0),
                                          pc.less_equal(t["lat"], 20.0))),
    ),
    "not-gt": ("NOT (lat > 50)", lambda t: pc.invert(pc.greater(t["lat"], 50.0))),
}


def kleene_counts(name: str, tables, key: str) -> dict:
    """Rows per `key` value that the WHERE keeps: a NULL selection drops."""
    counts: dict = {}
    for t in tables:
        kept = pc.filter(t, NEGATIONS[name][1](t), null_selection_behavior="drop")
        for v in kept[key].to_pylist():
            counts[v] = counts.get(v, 0) + 1
    return counts


def negation_sql(name: str, key: str) -> str:
    return f"SELECT {key} AS g0, count(*) AS c0 FROM t WHERE {NEGATIONS[name][0]} GROUP BY g0"


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
@pytest.mark.parametrize("name", list(NEGATIONS))
def test_negation_follows_three_valued_logic(name, engine, null_host_tables):
    """NOT over a NULL operand is NULL and drops the row, in both port
    engines (the JAX package's engines disagree with each other here)."""
    sql = negation_sql(name, "path")
    if engine == "gpu":
        got, routes = port_gpu(sql, null_host_tables)
        assert routes["cpu_fallback"] == 0, routes
    else:
        got = port_cpu(sql, null_host_tables)
    assert {r["g0"]: r["c0"] for r in got} == kleene_counts(name, null_host_tables, "path")


@pytest.mark.parametrize("name", list(NEGATIONS))
def test_negation_does_not_depend_on_the_route(monkeypatch, name, null_host_tables):
    """A scan whose first block folds dense and the rest block-local (the
    group space outgrows DENSE_G_MAX) answers as an all-dense scan, NULL
    hosts included."""
    sql = negation_sql(name, "host")
    on_device, routes = port_gpu(sql, null_host_tables)
    assert routes["cpu_fallback"] == routes["device_local"] == 0, routes
    monkeypatch.setattr(X, "DENSE_G_MAX", 4)  # the first block's 2 hosts (+ null) fit
    mixed, routes = port_gpu(sql, null_host_tables)
    assert (routes["device_cold"], routes["device_local"], routes["cpu_fallback"]) == (3, 2, 0), routes
    want = kleene_counts(name, null_host_tables, "host")
    assert {r["g0"]: r["c0"] for r in mixed} == {r["g0"]: r["c0"] for r in on_device} == want


def test_nan_value_poisons_only_its_own_group(tables):
    """One NaN lat makes sum(lat) NaN in its own group only (the JAX "tpu"
    engine spreads it to every group of the block)."""
    lat = tables[1]["lat"].to_pylist()
    status = tables[1]["status"].to_pylist()
    row = next(i for i, (v, s) in enumerate(zip(lat, status)) if v is not None and s == 301.0)
    lat[row] = math.nan
    poisoned = tables[1].set_column(tables[1].schema.get_field_index("lat"), "lat", pa.array(lat))
    blocks = [tables[0], poisoned, tables[2]]
    sql = "SELECT status AS g0, sum(lat) AS a0, count(lat) AS c0 FROM t WHERE status <> 200 GROUP BY g0"
    got, routes = port_gpu(sql, blocks)
    assert routes["cpu_fallback"] == 0, routes
    nan_groups = {r["g0"] for r in got if math.isnan(r["a0"])}
    assert nan_groups == {301.0}
    for ref in (jax_cpu(sql, blocks), port_cpu(sql, blocks)):
        assert {r["g0"] for r in ref if math.isnan(r["a0"])} == nan_groups
        finite = [r for r in ref if r["g0"] not in nan_groups]
        assert_rows(finite, [r for r in got if r["g0"] not in nan_groups], sql, exact_minmax=False)


@pytest.mark.parametrize("where", ["status <> 200", "lat <> 50", "lat <= 50", "NOT (lat > 50)"])
def test_nan_value_in_a_select(where, tables):
    """One NaN lat in a block, through the select path: x <> 50 is true on
    NaN and every ordered compare false (NOT (lat > 50) keeps it: NaN > 50
    is false, not NULL), as in both CPU engines; the NaN shows only in its
    own row."""
    lat = tables[1]["lat"].to_pylist()
    status = tables[1]["status"].to_pylist()
    row = next(i for i, (v, s) in enumerate(zip(lat, status)) if v is not None and s == 301.0)
    lat[row] = math.nan
    poisoned = tables[1].set_column(tables[1].schema.get_field_index("lat"), "lat", pa.array(lat))
    blocks = [tables[0], poisoned, tables[2]]
    sql = f"SELECT status, lat, bytes FROM t WHERE {where}"
    got, routes = port_gpu(sql, blocks)
    assert routes["cpu_fallback"] == 0 and routes["device_cold"] == 3, routes
    nan_rows = [r for r in got if r["lat"] is not None and math.isnan(r["lat"])]
    kept = where in ("status <> 200", "lat <> 50", "NOT (lat > 50)")
    assert nan_rows == ([{"status": 301.0, "lat": nan_rows[0]["lat"], "bytes": poisoned["bytes"][row].as_py()}]
                        if kept else [])

    def key(r):
        return tuple(repr(r[k]) for k in sorted(r))

    for ref in (jax_cpu(sql, blocks), port_cpu(sql, blocks)):
        assert sorted(map(key, ref)) == sorted(map(key, got))


ORDINAL_CASES = {
    "aggregate": ("SELECT host AS g0, count(*) AS c0, sum(bytes) AS a0, avg(lat) AS a1 FROM t "
                  "GROUP BY g0 ORDER BY {} DESC LIMIT 3", "a1"),
    "select": ("SELECT host, path, status, bytes AS b FROM t WHERE status >= 400 "
               "ORDER BY {} DESC, 2 LIMIT 20", "b"),
}


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
@pytest.mark.parametrize("name", list(ORDINAL_CASES))
def test_order_by_ordinal_names_the_select_item(name, engine, tables):
    """ORDER BY 4 sorts by the fourth select item, as ORDER BY its alias
    does (DataFusion's rule); the JAX package sorts by the constant 4."""
    text, alias = ORDINAL_CASES[name]
    run = (lambda sql: port_gpu(sql, tables)[0]) if engine == "gpu" else (
        lambda sql: port_cpu(sql, tables))
    by_position, by_alias = run(text.format(4)), run(text.format(alias).replace(", 2", ", path"))
    assert by_position == by_alias
    assert [r[alias] for r in by_position] == sorted((r[alias] for r in by_position), reverse=True)


@pytest.mark.parametrize("engine", ["gpu", "cpu"])
def test_order_by_ordinal_out_of_range(engine, tables):
    from parseable_tpu_torch.query.executor import ExecError

    sql = "SELECT host, count(*) AS c FROM t GROUP BY host ORDER BY 3"
    with pytest.raises(ExecError, match="position 3"):
        port_gpu(sql, tables) if engine == "gpu" else port_cpu(sql, tables)


# ---------------------------------------- ROADMAP list 3: repaired answers


def list3_run(engine: str, sql: str, api_range) -> list[str]:
    """One of list 3's queries over chip_smoke's `list3_table` on the
    port's "gpu" engine (plain versions; every block on the device path)
    or "cpu" engine, or the JAX CPU engine, with the API time range where
    the case has one."""
    from parseable_tpu_torch.query.planner import TimeBounds
    from parseable_tpu_torch.utils.timeutil import parse_rfc3339

    table = chip_smoke.list3_table(pa)
    if engine == "jax_cpu":
        return chip_smoke.list3_rows(jax_cpu(sql, [table]))
    lp = port_plan(port_parse(sql))
    if api_range:
        lp.time_bounds = lp.time_bounds.intersect(TimeBounds(*map(parse_rfc3339, api_range)))
    if engine == "port_cpu":
        return chip_smoke.list3_rows(PortCpuExecutor(lp).execute(iter([table])).to_pylist())
    get_hotset().clear()
    block = table.replace_schema_metadata({X.SOURCE_ID_META: b"list3"})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P_TPU_ENC_CACHE", "0")
        ex = X.GpuQueryExecutor(lp, device="cpu")
        rows = ex.execute(iter([block])).to_pylist()
    assert ex.route_stats["cpu_fallback"] == 0, ex.route_stats
    return chip_smoke.list3_rows(rows)


def list3_cases(item: str) -> list:
    return [pytest.param(where, api_range, id=case)
            for it, case, where, api_range in chip_smoke.LIST3 if it == item]


def hold_list3(where, api_range, with_jax: bool) -> None:
    for sql in chip_smoke.list3_queries(where):
        got = list3_run("port_gpu", sql, api_range)
        assert got == list3_run("port_cpu", sql, api_range), sql
        if with_jax:
            assert got == list3_run("jax_cpu", sql, api_range), sql


@pytest.mark.parametrize("where,api_range", list3_cases("strings"))
def test_string_predicates_match_arrow_on_every_value(where, api_range):
    """LIKE and regexp_like LUTs come from the CPU engine's own pyarrow
    calls: newlines inside and after a match, '_' over a newline, '$'
    before a trailing newline and \\d on Arabic-Indic digits answer as on
    the CPU engines."""
    hold_list3(where, api_range, with_jax=True)


@pytest.mark.parametrize("where,api_range", list3_cases("f64"))
def test_numeric_compares_are_exact_past_f32(where, api_range):
    """A compare or IN over a column whose values f32 does not hold (2^24 +
    1, 2^31 + 1, 250.00000001, 1e-46) reads the column's f64 copy: the
    rows are the CPU engines'."""
    hold_list3(where, api_range, with_jax=True)


@pytest.mark.parametrize("where,api_range", list3_cases("null"))
def test_compare_with_a_null_literal_keeps_no_row(where, api_range):
    """host != NULL and NOT (host = NULL) are NULL on every row."""
    hold_list3(where, api_range, with_jax=True)
    assert list3_run("port_gpu", chip_smoke.list3_queries(where)[0], api_range) == []


# rows (ms after 10:00) that each sub-ms case keeps: 10:00:00.000 (0) and
# 10:10:00.001 (600,001) fall outside [10:00:00.0007, 10:10:00.0007]
SUBMS_KEPT = {
    "api-range": [1, 2, 3, 4, 5, 300_000, 599_999, 600_000],
    "ge-lt": [1, 2, 3, 4, 5, 300_000, 599_999, 600_000],
    "gt-le": [1, 2, 3, 4, 5, 300_000, 599_999, 600_000],
    "between": [1, 2, 3, 4, 5, 300_000, 599_999, 600_000],
    "eq-and-not-eq": [1, 599_999, 600_001],  # no ms equals a sub-ms literal
}


@pytest.mark.parametrize("where,api_range", list3_cases("subms"))
def test_sub_ms_time_bounds_round_up(where, api_range, request):
    """A bound or literal at 10:00:00.000700 keeps the row stamped at
    10:00:00.000 out of ts >= and the row at 10:10:00.000 in ts < (and
    likewise for > and <=), on both port engines; the JAX package floors
    (ROADMAP "differences by design")."""
    hold_list3(where, api_range, with_jax=False)
    base = datetime(2024, 5, 1, 10, 0)
    kept = SUBMS_KEPT[request.node.callspec.id]
    want = [r for r in chip_smoke.list3_table(pa).to_pylist()
            if (r["p_timestamp"] - base) // timedelta(milliseconds=1) in kept]
    sql = chip_smoke.list3_queries(where)[0]
    assert list3_run("port_gpu", sql, api_range) == chip_smoke.list3_rows(want)


def test_chip_smoke_list3_phase_runs_on_the_cpu():
    """chip_smoke.py's phase 9, on the CPU: every repro of list 3 through
    the "gpu" engine's plain path equals the "cpu" engine, a select and a
    GROUP BY each."""
    assert chip_smoke.drive_list3(device="cpu") == 2 * len(chip_smoke.LIST3)
