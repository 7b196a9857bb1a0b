"""High-cardinality GROUP BY in the port, on the CPU: the two-phase partials
(`query/partials.py`), the CPU engine's two-phase path, and the GPU
engine's block-local mode with pair compaction (`executor_cuda
._local_block`; K3a's KEY_CODE ids, then A, B and K7 through their plain
versions on CPU tensors).

The inputs are those of tests/test_highcard.py (three blocks, ~120k distinct
users, overlapping across blocks), made from a numpy seed. Each query runs
through the port's "gpu" engine (`device="cpu"`) and its CPU engine, and
is held against the JAX package's `TpuQueryExecutor` (CPU JAX) and its CPU
engine. Only the port's DENSE_G_MAX and LOCAL_G_MAX are lowered, so the
JAX engines stay on their dense path, whose answer is the same.

Tolerances (the model of `tests/test_torch_executor.py assert_rows`, by
alias prefix, vectorized here for 10^5-row answers): keys `g*` and counts
`c*` exact (f32 adds of 0/1 below 2^24); sums, averages and stddev/var `a*`
rel 2e-4, abs 1e-6 (f32 block sums and f32 centred moments against f64,
and against another f32 summation order); min/max `m*` rel 2e-4, abs 1e-6
against the f64 CPU engines (f32 rounding of the value); NULLs where the
reference has them.
"""

import numpy as np
import pyarrow as pa
import pytest
from datetime import datetime, timedelta

from parseable_tpu.query import executor_tpu as ET
from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query import partials as PT
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from tests.test_torch_executor import jax_cpu, jax_tpu, port_cpu, port_gpu


def assert_rows(ref: list[dict], got: list[dict], sql: str, exact_minmax: bool = False,
                ordered: bool = False) -> None:
    """`ref` and `got` hold the same rows (sorted on the `g*` keys unless
    `ordered`), within the module's tolerances."""
    assert len(ref) == len(got), (sql, len(ref), len(got))
    if not ref:
        return
    a, b = pa.Table.from_pylist(ref), pa.Table.from_pylist(got)
    assert set(a.column_names) == set(b.column_names), sql
    keys = sorted(c for c in a.column_names if c.startswith("g"))
    if not ordered and keys:
        a, b = _sorted(a, keys), _sorted(b, keys)
    for col in ref[0]:
        x, y = a[col].to_pylist(), b[col].to_pylist()
        if col.startswith("g") or col.startswith("c") or (col.startswith("m") and exact_minmax):
            assert x == y, (sql, col)
            continue
        xn = np.array([np.nan if v is None else v for v in x], dtype=np.float64)
        yn = np.array([np.nan if v is None else v for v in y], dtype=np.float64)
        assert np.array_equal(np.isnan(xn), np.isnan(yn)), (sql, col, "NULLs differ")
        both = ~np.isnan(xn)
        bad = np.abs(xn[both] - yn[both]) > 1e-6 + 2e-4 * np.abs(xn[both])
        assert not bad.any(), (sql, col, xn[both][bad][:5], yn[both][bad][:5])


def _sorted(t: pa.Table, keys: list[str]) -> pa.Table:
    for k in keys:
        t = t.append_column(f"__s{k}", pa.array([str(v) for v in t[k].to_pylist()]))
    return t.sort_by([(f"__s{k}", "ascending") for k in keys])


@pytest.fixture(autouse=True)
def jax_program_cache():
    """The JAX engine's program cache as it was before the test: a program
    this file compiled would otherwise be a cache hit for a later test of
    the JAX package that counts the programs it builds."""
    before = set(ET._PROGRAM_CACHE)
    yield
    for key in set(ET._PROGRAM_CACHE) - before:
        del ET._PROGRAM_CACHE[key]


@pytest.fixture(scope="module")
def highcard_tables() -> list[pa.Table]:
    """Three blocks, ~120k distinct user ids in all, overlapping across
    blocks (tests/test_highcard.py's inputs)."""
    rng = np.random.default_rng(11)
    tables = []
    for b in range(3):
        n = 60_000
        uid = rng.integers(b * 30_000, b * 30_000 + 60_000, n)
        tables.append(
            pa.table(
                {
                    "user": pa.array([f"u{int(x)}" for x in uid]),
                    "bytes": pa.array(rng.random(n) * 100.0),
                    "lat": pa.array(rng.random(n) * 10.0),
                }
            )
        )
    return tables


def all_engines(sql: str, tables, jax_tpu_too: bool = True) -> tuple[list[dict], dict]:
    """The port's "gpu" answer and routes, after holding it and the port's
    CPU engine against the JAX engines."""
    got, routes = port_gpu(sql, tables)
    cpu = port_cpu(sql, tables)
    refs = [jax_cpu(sql, tables)] + ([jax_tpu(sql, tables)] if jax_tpu_too else [])
    for ref in refs:
        assert_rows(ref, got, sql, exact_minmax=False)
        assert_rows(ref, cpu, sql, exact_minmax=False)
    return got, routes


def test_direct_local_fold(monkeypatch, highcard_tables):
    """Past the dense budget from the first block on: every block folds
    block-local on the device, none on the host."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    sql = ("SELECT user AS g0, count(*) AS c0, sum(bytes) AS a0, min(lat) AS m0, "
           "max(lat) AS m1, avg(bytes) AS a1 FROM t GROUP BY g0")
    got, routes = all_engines(sql, highcard_tables)
    assert len(got) > 80_000  # genuinely high-cardinality
    assert routes["device_local"] == routes["device_cold"] == 3, routes
    assert routes["cpu_fallback"] == 0, routes


def test_stddev_and_var_fold_block_local(monkeypatch, highcard_tables):
    """Each block's centred M2 (K7 about its own means, no Chan merge)
    becomes a raw sum of squares M2 + s^2/n in f64 that merges exactly."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    sql = ("SELECT user AS g0, count(*) AS c0, stddev(lat) AS a0, var(bytes) AS a1, "
           "count(lat) AS c1 FROM t GROUP BY g0")
    got, routes = all_engines(sql, highcard_tables)
    assert routes["device_local"] == 3 and routes["cpu_fallback"] == 0, routes
    assert any(r["a0"] is None for r in got) and any(r["a0"] is not None for r in got)


def test_where_in_local_mode(monkeypatch, highcard_tables):
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    sql = "SELECT user AS g0, count(*) AS c0, sum(lat) AS a0 FROM t WHERE bytes > 50 GROUP BY g0"
    _, routes = all_engines(sql, highcard_tables)
    assert routes["device_local"] == 3 and routes["cpu_fallback"] == 0, routes


def test_dense_epoch_switches_to_local_mid_scan(monkeypatch):
    """Blocks that start low-cardinality and then explode: the dense epoch's
    accumulator becomes a partial and merges with the local blocks'."""
    rng = np.random.default_rng(5)
    low = pa.table({"k": pa.array([f"k{int(x)}" for x in rng.integers(0, 20, 30_000)]),
                    "v": pa.array(rng.random(30_000))})
    high = pa.table({"k": pa.array([f"h{i}" for i in range(3_000_000, 3_030_000)]),
                     "v": pa.array(rng.random(30_000))})
    mixed = pa.table({"k": pa.array([f"k{int(x)}" if x % 2 else f"h{3_000_000 + int(x)}"
                                     for x in rng.integers(0, 40_000, 30_000)]),
                      "v": pa.array(rng.random(30_000))})
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 12)
    sql = "SELECT k AS g0, count(*) AS c0, sum(v) AS a0, max(v) AS m0 FROM t GROUP BY g0"
    _, routes = all_engines(sql, [low, high, mixed])
    assert (routes["device_cold"], routes["device_local"], routes["cpu_fallback"]) == (3, 2, 0), routes


def test_capacity_epochs_flush_to_partials(monkeypatch):
    """Below the budget, a growing dictionary opens new capacity epochs;
    each old epoch leaves as a partial table (no per-group Python), and a
    NULL key keeps its group across them."""
    rng = np.random.default_rng(6)
    tables = []
    for card in (3, 40, 700):
        keys = [f"u{int(x)}" if x % 9 else None for x in rng.integers(0, card, 5000)]
        tables.append(pa.table({"k": pa.array(keys), "v": pa.array(rng.random(5000))}))
    flushed = []
    real = X.GpuQueryExecutor._dense_to_partial

    def spy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        flushed.append(out.num_rows)
        return out

    monkeypatch.setattr(X.GpuQueryExecutor, "_dense_to_partial", spy)
    sql = "SELECT k AS g0, count(*) AS c0, avg(v) AS a0 FROM t GROUP BY g0"
    # not against the JAX "tpu" engine: it relabels a NULL key after a
    # capacity epoch (ROADMAP list 3, not port faults)
    got, routes = all_engines(sql, tables, jax_tpu_too=False)
    assert len(flushed) == 3 and routes["device_local"] == 0, (flushed, routes)
    assert sum(1 for r in got if r["g0"] is None) == 1


def test_multikey_block_local(monkeypatch):
    """Two keys whose per-block capacity product still fits LOCAL_G_MAX."""
    rng = np.random.default_rng(7)
    n = 50_000
    t = pa.table({"a": pa.array([f"a{int(x)}" for x in rng.integers(0, 2_000, n)]),
                  "b": pa.array([f"b{int(x)}" for x in rng.integers(0, 500, n)]),
                  "v": pa.array(rng.random(n))})
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 12)
    sql = "SELECT a AS g0, b AS g1, count(*) AS c0, sum(v) AS a0 FROM t GROUP BY g0, g1"
    _, routes = all_engines(sql, [t])
    assert routes["device_local"] == 1, routes


def test_pair_mode(monkeypatch):
    """The capacity product passes LOCAL_G_MAX: the block's actual key
    combinations compact with np.unique into pair codes (`__pairkey`, a
    KEY_CODE slot of the aux copy) and fold on the device, exactly."""
    rng = np.random.default_rng(21)
    tables = []
    for b in range(2):
        n = 30_000
        tables.append(pa.table({
            "a": pa.array([f"a{int(x)}" for x in rng.integers(0, 500, n)]),
            "b": pa.array([f"b{int(x)}" if x % 11 else None for x in rng.integers(0, 500, n)]),
            "v": pa.array(rng.random(n)),
        }))
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 12)
    monkeypatch.setattr(X, "LOCAL_G_MAX", 1 << 16)  # 512 x 512 = 2^18 > the budget
    pairs = []
    real = X.GpuQueryExecutor._partial_from_arrays

    def spy(self, arr, lay, keyinfo, specs, composite_vals=None):
        pairs.append(composite_vals is not None)
        return real(self, arr, lay, keyinfo, specs, composite_vals)

    monkeypatch.setattr(X.GpuQueryExecutor, "_partial_from_arrays", spy)
    sql = ("SELECT a AS g0, b AS g1, count(*) AS c0, sum(v) AS a0, min(v) AS m0, "
           "stddev(v) AS a1 FROM t GROUP BY g0, g1 ORDER BY a0 DESC LIMIT 50")
    got, routes = port_gpu(sql, tables)
    assert pairs == [True, True] and routes["device_local"] == 2, (pairs, routes)
    for ref in (jax_cpu(sql, tables), jax_tpu(sql, tables), port_cpu(sql, tables)):
        assert_rows(ref, got, sql, exact_minmax=False, ordered=True)


def test_pair_mode_reads_codes_back_from_a_resident_block(monkeypatch, tmp_path):
    """A block the hot set holds has no host codes (they are stripped once
    it ships): pair mode reads its key codes back from the device, priced
    in d2h_bytes, cold and device-warm."""
    from tests.test_torch_tiering import STREAM, write_lake
    from parseable_tpu_torch.ops import hotset as PH
    from parseable_tpu_torch.query.session import QuerySession

    rng = np.random.default_rng(22)
    n = 20_000
    base = datetime(2024, 5, 1, 10, 0)
    t = pa.table({
        DEFAULT_TIMESTAMP_KEY: pa.array([base + timedelta(milliseconds=int(x))
                                         for x in np.sort(rng.integers(0, 60_000, n))],
                                        pa.timestamp("ms")),
        "a": pa.array([f"a{int(x)}" for x in rng.integers(0, 400, n)]),
        "b": pa.array([f"b{int(x)}" for x in rng.integers(0, 400, n)]),
        "v": pa.array(rng.random(n)),
    })
    p = write_lake(tmp_path, [t])
    read_back = []
    real = X.GpuQueryExecutor._host_codes

    def spy(self, enc, block, column):
        read_back.append(len(enc.columns[column].values) == 0)
        return real(self, enc, block, column)

    try:
        monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 10)
        monkeypatch.setattr(X, "LOCAL_G_MAX", 1 << 15)
        monkeypatch.setattr(X.GpuQueryExecutor, "_host_codes", spy)
        sql = f"SELECT a AS g0, b AS g1, count(*) AS c0, sum(v) AS a0 FROM {STREAM} GROUP BY g0, g1"
        PH.get_hotset().clear()
        runs = [QuerySession(p, engine="gpu", device="cpu").query(sql) for _ in range(2)]
        cold, warm = (r.stats["device_routes"] for r in runs)
        assert (cold["device_cold"], warm["device_warm"], warm["device_local"]) == (1, 1, 1), warm
        assert read_back == [True] * 4, read_back  # two keys, two runs
        # the accumulator (3 rows of pow2(pairs) groups) and two int16 code columns
        assert warm["d2h_bytes"] == cold["d2h_bytes"] > 3 * 4 * len(runs[0].table), warm
        want = port_cpu(sql.replace(STREAM, "t"), [t])
        for r in runs:
            assert_rows(want, r.table.to_pylist(), sql, exact_minmax=False)
    finally:
        p.shutdown()
        PH.get_hotset().clear()


def test_timebin_plus_dict_key(monkeypatch):
    """date_bin x user in local mode: the bin is the block's own (its first
    bin is the origin), the user its own dictionary code."""
    rng = np.random.default_rng(9)
    n = 40_000
    base = datetime(2024, 5, 1)
    tables = []
    for b in range(2):
        ts = [base + timedelta(seconds=int(s)) for s in rng.integers(b * 900, b * 900 + 1800, n)]
        tables.append(pa.table({
            DEFAULT_TIMESTAMP_KEY: pa.array(ts, pa.timestamp("ms")),
            "user": pa.array([f"u{int(x)}" for x in rng.integers(0, 30_000, n)]),
            "v": pa.array(rng.random(n)),
        }))
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    sql = ("SELECT date_bin(interval '1 minute', p_timestamp) AS g0, user AS g1, count(*) AS c0, "
           "max(v) AS m0, stddev(v) AS a0 FROM t GROUP BY g0, g1")
    _, routes = all_engines(sql, tables)
    assert routes["device_local"] == 2, routes


def test_nulls_in_the_key(monkeypatch):
    rng = np.random.default_rng(13)
    n = 40_000
    vals = [f"u{int(x)}" if x % 7 else None for x in rng.integers(0, 40_000, n)]
    t = pa.table({"user": pa.array(vals), "v": pa.array(rng.random(n))})
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 12)
    sql = "SELECT user AS g0, count(*) AS c0, sum(v) AS a0 FROM t GROUP BY g0"
    got, routes = all_engines(sql, [t])
    assert routes["device_local"] == 1, routes
    assert sum(1 for r in got if r["g0"] is None) == 1


def test_host_fallback_block_merges_into_local_partials(monkeypatch, highcard_tables):
    """A block the device refuses in local mode folds on the host
    (HashAggregator); its groups merge with the local blocks' partials."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    real = X.GpuQueryExecutor._local_block
    calls = []

    def refuse_second(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise X.UnsupportedOnDevice("refused by the test")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(X.GpuQueryExecutor, "_local_block", refuse_second)
    sql = ("SELECT user AS g0, count(*) AS c0, sum(bytes) AS a0, min(lat) AS m0, "
           "stddev(lat) AS a1 FROM t GROUP BY g0")
    _, routes = all_engines(sql, highcard_tables)
    assert (routes["device_local"], routes["cpu_fallback"]) == (2, 1), routes


@pytest.mark.parametrize(
    "agg",
    ["count(distinct lvl) AS c1", "approx_percentile_cont(lat, 0.5) AS a1"],
    ids=["distinct", "percentile"],
)
def test_sketch_and_set_state_still_take_the_host(monkeypatch, agg):
    """count(distinct) and percentiles need the global group space: past
    DENSE_G_MAX (their own budgets still met) the rest of the scan folds on
    the host, as in JAX."""
    rng = np.random.default_rng(31)
    tables = [
        pa.table({"user": pa.array([f"u{int(x)}" for x in rng.integers(0, 1500, 5000)]),
                  "lvl": pa.array(rng.choice(["a", "b", "c", "d"], 5000).tolist()),
                  "lat": pa.array(rng.random(5000) * 10.0)})
        for _ in range(2)
    ]
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 10)
    sql = f"SELECT user AS g0, count(*) AS c0, {agg} FROM t GROUP BY g0"
    got, routes = port_gpu(sql, tables)
    assert routes["device_local"] == 0 and routes["cpu_fallback"] == 2, routes
    # the host sketch is exact below 1,024 values a group, in both packages
    for ref in (jax_cpu(sql, tables), port_cpu(sql, tables)):
        assert_rows(ref, got, sql, exact_minmax=False)


def test_cpu_engine_is_two_phase(monkeypatch, highcard_tables):
    """The CPU engine folds a partializable GROUP BY block by block into
    partial tables and merges them once; other aggregates keep the hash
    aggregate."""
    merges = []
    real = PT.merge_partials
    monkeypatch.setattr(PT, "merge_partials", lambda *a: merges.append(len(a[0])) or real(*a))
    sql = "SELECT user AS g0, count(*) AS c0, avg(bytes) AS a0, var(lat) AS a1 FROM t GROUP BY g0"
    assert_rows(jax_cpu(sql, highcard_tables), port_cpu(sql, highcard_tables), sql, False)
    assert merges == [3]
    port_cpu("SELECT user AS g0, count(distinct lat) AS c0 FROM t GROUP BY g0", highcard_tables[:1])
    assert merges == [3]


def test_partials_match_the_jax_merge(highcard_tables):
    """The port's partial tables and merge give the JAX package's interim
    (`parseable_tpu/query/partials.py`), key types and all."""
    from parseable_tpu.query import partials as JPT
    from parseable_tpu.query.executor import QueryExecutor as JaxCpuExecutor
    from parseable_tpu.query.planner import plan as jax_plan
    from parseable_tpu.query.sql import parse_sql as jax_parse

    sql = ("SELECT user, count(*), sum(bytes), min(lat), max(lat), stddev(lat), count(lat) "
           "FROM t GROUP BY user")
    port_ex = PortCpuExecutor(port_plan(port_parse(sql)))
    jax_ex = JaxCpuExecutor(jax_plan(jax_parse(sql)))
    pspecs = port_ex.build_aggregator()[0].specs
    jspecs = jax_ex.build_aggregator()[0].specs
    pparts = [PT.partial_from_block(t, port_ex.plan.select.group_by, pspecs) for t in highcard_tables]
    jparts = [JPT.partial_from_block(t, jax_ex.plan.select.group_by, jspecs) for t in highcard_tables]
    for pp, jp in zip(pparts, jparts):
        assert pp.equals(jp)
    got = PT.merge_partials(pparts, pspecs, 1)
    want = JPT.merge_partials(jparts, jspecs, 1)
    assert got.schema == want.schema
    got, want = (PT.decode_dictionary_columns(t).sort_by("__g0") for t in (got, want))
    assert got.equals(want)
