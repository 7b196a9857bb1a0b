"""The port's statistics (stddev/var, approximate percentiles, count(distinct)
and approx_distinct) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's counterparts, module by module (`query/sketch.py`,
`ops/hll_sketch.py`), kernel by kernel (the plain versions of K5-K7 in
`ops/stats_cuda.py` against the JAX dense fold's own formulas,
`parseable_tpu/query/executor_tpu.py:889, :938, :2931-2981`), and for the
slice as a whole: the port's "gpu" engine with `device="cpu"` against the
JAX "tpu" and "cpu" engines, and the port's CPU engine against the JAX CPU
engine.

approx_distinct hashes values with xxHash64. The JAX package computes it with
its native library and falls back to blake2b when that library does not
load, which gives other registers by design. The comparisons that need that
library (the HLL sketch, and the slice's queries against the JAX engines)
are in `tests/test_torch_ingest.py`, beside the port's other tests that
load it, with this file's helpers and tolerances; they fail (they do not
skip) without it. Nothing here loads it.

Tolerances:
- counts, count(distinct), approx_distinct, sketches and histograms: exact
  (the same arithmetic on the same values), except K6 rows whose f32 log2
  lies within one ulp of a bin edge (two log2 implementations may put them
  in neighbouring bins): those are counted and allowed, and only those;
- K7 against the JAX fold: rel 1e-5 (f64 plain version vs f32 segment sums);
- stddev/var: rel 2e-4 (f32 device moments against f64);
- percentiles: rel 1e-3 against the JAX "tpu" engine (the same f32
  histogram, up to edge rows); rel 0.06 against the CPU engines (the JAX
  tests' own bound, tests/test_device_stats.py:149-162); p0/p100 exact at
  f32 (tests/test_device_stats.py:179).
"""

import random
from datetime import datetime, timedelta

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

import parseable_tpu.ops.hll_sketch as JH
import parseable_tpu.ops.kernels as JK
import parseable_tpu.query.sketch as JS
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.query import executor_tpu as ET
from parseable_tpu.query.executor import QueryExecutor as JaxCpuExecutor
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.event.format import xxh64
from parseable_tpu_torch.ops import hll_sketch as PH
from parseable_tpu_torch.ops import kernels as PK
from parseable_tpu_torch.ops import stats_cuda as SC
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query import sketch as PS
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse

BASE = datetime(2024, 5, 1, 10, 0)


# ------------------------------------------------------------------ sketch


def _values(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.concatenate([np.exp(rng.normal(2, 3, n)), -np.exp(rng.normal(1, 2, n // 3)),
                        np.zeros(n // 10), [np.nan, np.inf, -np.inf, 1e-300, 3.4e38]])
    rng.shuffle(v)
    return v


@pytest.mark.parametrize("n", [50, 1000, 1025, 20_000])  # exact, at SMALL, folded, binned
def test_quantile_sketch_matches_jax(n):
    parts = np.array_split(_values(n, n), 4)
    sj, sp = JS.QuantileSketch(), PS.QuantileSketch()
    for a in parts[:2]:
        sj.update(a)
        sp.update(a)
    oj, op = JS.QuantileSketch(), PS.QuantileSketch()
    for a in parts[2:]:
        oj.update(a)
        op.update(a)
    sj.merge(oj.copy())
    sp.merge(op.copy())
    assert sp.count == sj.count and sp.vmin == sj.vmin and sp.vmax == sj.vmax
    for p in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        # +-inf values make some exact quantiles NaN, in both alike
        assert np.array_equal([sp.quantile(p)], [sj.quantile(p)], equal_nan=True), p


def test_device_histogram_decodes_as_jax():
    rng = np.random.default_rng(3)
    hists = (rng.random((6, JS.DEVICE_NB)) < 0.05) * rng.integers(1, 50, (6, JS.DEVICE_NB))
    hists[2] = 0
    vmins, vmaxs = -rng.random(6) * 100, rng.random(6) * 100
    assert PS.DEVICE_NB == JS.DEVICE_NB and (PS.BINS, PS.LOG_LO, PS.LOG_HI) == (
        JS.BINS, JS.LOG_LO, JS.LOG_HI)
    for p in (0.0, 0.5, 0.99, 1.0):
        vp, okp = PS.hist_quantile(hists, vmins, vmaxs, p)
        vj, okj = JS.hist_quantile(hists, vmins, vmaxs, p)
        assert np.array_equal(okp, okj) and np.array_equal(vp, vj)
        for i in range(6):
            a = PS.QuantileSketch.from_device_hist(hists[i], vmins[i], vmaxs[i])
            b = JS.QuantileSketch.from_device_hist(hists[i], vmins[i], vmaxs[i])
            assert a.count == b.count and a.quantile(p) == b.quantile(p)


# --------------------------------------------------------------------- HLL


def test_batched_xxh64_matches_xxh64_and_the_public_vectors():
    vectors = {b"": 0xEF46DB3751D8E999, b"a": 0xD24EC4F1A98C6E5B, b"abc": 0x44BC2CF5AD770999,
               b"Nobody inspects the spammish repetition": 0xFBCEA83C8A378BF1}
    assert list(PH.xxh64_many(list(vectors))) == list(vectors.values())
    rng = random.Random(7)
    items = [bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 100))) for _ in range(2000)]
    items += [bytes(range(k)) for k in range(72)] + [b"x" * 1000]
    assert [int(h) for h in PH.xxh64_many(items)] == [xxh64(b) for b in items]
    idx, rank = PH.idx_rank_many(PH.xxh64_many(items))
    assert [(int(i), int(r)) for i, r in zip(idx, rank)] == [
        PH.hash_to_idx_rank(xxh64(b)) for b in items]


# ---------------------------------------------- plain kernels vs the JAX fold


def _fold_inputs(seed: int, n: int, g: int, v: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, g, n).astype(np.int32)
    ids[: n // 3] = g // 2  # a crowded group
    return rng, ids, rng.integers(0, v, n).astype(np.int16), rng.random(n) < 0.8


@pytest.mark.parametrize("hll", [False, True], ids=["presence", "hll"])
def test_distinct_fold_plain_matches_the_jax_fold(hll):
    """K5's plain version against executor_tpu.py:2931-2953, exact, folding
    two blocks into one accumulator."""
    g, v = 16, 300
    cap = JH.HLL_M if hll else 512
    dacc_j = jnp.zeros(g * cap, jnp.float32)
    dacc_p = torch.zeros(g * cap)
    for seed in (1, 2):
        rng, ids, codes, mask = _fold_inputs(seed, 20_000, g, v)
        if hll:
            lut = np.stack(PH.luts_for_dictionary([f"v{i}" for i in range(v)])).astype(np.int32)
            jcodes = jnp.minimum(jnp.asarray(lut[0])[codes.astype(np.int32)], cap - 1)
            val = jnp.where(mask, jnp.asarray(lut[1])[codes.astype(np.int32)].astype(jnp.float32), 0.0)
        else:
            lut = rng.integers(0, cap + 8, v).astype(np.int32)  # past cap: clamps to cap - 1
            jcodes = jnp.minimum(jnp.asarray(lut)[codes.astype(np.int32)], cap - 1)
            val = jnp.asarray(mask).astype(jnp.float32)
        upd = jax.ops.segment_max(val, jnp.asarray(ids) * cap + jcodes, num_segments=g * cap)
        dacc_j = jnp.maximum(dacc_j, upd)
        got = SC.distinct_fold(dacc_p, torch.from_numpy(ids), torch.from_numpy(codes),
                               torch.from_numpy(mask), cap, torch.from_numpy(lut))
        assert got is dacc_p  # folded in place
    assert np.array_equal(dacc_p.numpy(), np.asarray(dacc_j))


def test_masked_distinct_bitmap_matches_jax():
    rng, ids, codes, mask = _fold_inputs(4, 10_000, 8, 40)
    codes[::50] = 60  # past num_values: counts as the last value
    ref = np.asarray(JK.masked_distinct_bitmap(jnp.asarray(ids), jnp.asarray(codes.astype(np.int32)),
                                               jnp.asarray(mask), 8, 48))
    got = PK.masked_distinct_bitmap(torch.from_numpy(ids), torch.from_numpy(codes),
                                    torch.from_numpy(mask), 8, 48).numpy()
    assert got.shape == ref.shape
    # presence is > 0 in both; a cell no row reaches is -inf in JAX, 0 here
    assert np.array_equal(got > 0, ref > 0)
    assert set(np.unique(got)) <= {0.0, 1.0}


def _edge_rows(vals: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Rows whose f32 log2|v| lies within one ulp of a bin edge."""
    with np.errstate(divide="ignore"):
        mag = np.log2(np.abs(vals)).astype(np.float32)
    bins = [SC.pct_bins(torch.from_numpy(np.nextafter(mag, np.float32(d)))).numpy()
            for d in (np.inf, -np.inf)]
    return live & (vals != 0) & ~np.isnan(vals) & (bins[0] != bins[1])


def test_pct_histogram_plain_matches_the_jax_fold():
    """K6's plain version against executor_tpu.py:2954-2981, bin for bin,
    except rows within one ulp of a bin edge (counted, and only those)."""
    g, n = 8, 50_000
    rng, ids, _, mask = _fold_inputs(6, n, g, 2)
    vals = np.concatenate([rng.random(n // 2) * 500, -np.exp(rng.normal(0, 15, n - n // 2))])
    vals = vals.astype(np.float32)
    rng.shuffle(vals)
    vals[::101], vals[::103] = 0.0, np.nan
    vals[1:8] = [np.inf, -np.inf, 3.4e38, -3.4e38, 1e-45, -1e-40, 1.2e-38]  # subnormals count as 0
    v = jnp.asarray(vals)
    pm = jnp.asarray(mask) & ~jnp.isnan(v)
    mag = jnp.clip(jnp.log2(jnp.abs(v)), jnp.float32(JS.LOG_LO), jnp.float32(JS.LOG_HI - 1e-6))
    bin_ = jnp.clip(((mag - jnp.float32(JS.LOG_LO)) * jnp.float32(ET.PCT_SCALE)).astype(jnp.int32),
                    0, ET.PCT_BINS - 1)
    slot = jnp.where(v == 0.0, jnp.int32(2 * ET.PCT_BINS),
                     jnp.where(v > 0, jnp.int32(ET.PCT_BINS) + bin_, bin_))
    ref = jax.ops.segment_sum(pm.astype(jnp.float32), jnp.asarray(ids) * jnp.int32(JS.DEVICE_NB) + slot,
                              num_segments=g * JS.DEVICE_NB)
    got = SC.pct_histogram(torch.zeros(g * JS.DEVICE_NB), torch.from_numpy(vals),
                           torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    edge = int(_edge_rows(vals, mask).sum())
    moved = int(np.abs(got - np.asarray(ref)).sum())
    assert got.sum() == np.asarray(ref).sum() == int((mask & ~np.isnan(vals)).sum())
    assert moved <= 2 * edge, (moved, edge)  # a moved row shows in two bins
    assert edge < n // 1000


def test_centered_m2_plain_matches_jax_block_m2():
    """K7's plain version against executor_tpu.py:889 _block_m2, rel 1e-5,
    and the Chan merge against :938, rel 1e-6."""
    g, n, q = 8, 40_000, 2
    rng, ids, _, mask = _fold_inputs(8, n, g, 2)
    vals = (rng.random((q, n)) * 50_000 - 1000).astype(np.float32)
    valid = rng.random((q, n)) < 0.9

    class Layout:
        sum_cols, sq_cols = ["s0"], ["x0", "x1"]

    dev = {"x0": jnp.asarray(vals[0]), "x0__valid": jnp.asarray(valid[0]),
           "x1": jnp.asarray(vals[1]), "x1__valid": jnp.asarray(valid[1])}
    vm = valid & mask[None]
    pac = np.stack([np.zeros(g)] + [np.bincount(ids[vm[i]], minlength=g) for i in range(q)])
    sums = np.stack([np.zeros(g)] + [np.bincount(ids[vm[i]], vals[i][vm[i]], g) for i in range(q)])
    pac, sums = pac.astype(np.float32), sums.astype(np.float32)
    m2_j, _, _ = ET._block_m2(dev, Layout, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pac),
                              jnp.asarray(sums), g)
    mean = torch.from_numpy(sums[1:]) / torch.from_numpy(pac[1:]).clamp_min(1.0)
    got = SC.centered_m2(torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(valid),
                         torch.from_numpy(mask), mean)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(m) for m in m2_j]), rtol=1e-5)

    parts = [rng.random((3, g)).astype(np.float32) * s for s in (100, 5e4, 1e9)] * 2
    parts[0][0, 0] = parts[3][1, 2] = 0.0  # an empty side
    ref = np.asarray(ET._chan_merge_m2(*map(jnp.asarray, parts)))
    np.testing.assert_allclose(X._chan_merge_m2(*map(torch.from_numpy, parts)).numpy(), ref,
                               rtol=1e-6)


# ------------------------------------------------------------- the slice


def stats_table(seed: int, n: int, n_hosts: int) -> pa.Table:
    """Access-log-like rows: `lat` with nulls, negatives and zeros; `x` the
    same with NaN as well (percentiles drop NaN; stddev would turn NaN)."""
    rng = np.random.default_rng(seed)
    ms = rng.integers(0, 2 * 3600 * 1000, n)
    lat = rng.random(n) * 100
    lat[rng.random(n) < 0.05] = 0.0
    lat[rng.random(n) < 0.1] *= -1
    null = rng.random(n) < 0.1
    x = np.exp(rng.normal(3, 2, n)) * np.where(rng.random(n) < 0.2, -1, 1)
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.05] = 0.0
    return pa.table(
        {
            "p_timestamp": pa.array(
                [BASE + timedelta(milliseconds=int(v)) for v in ms], pa.timestamp("ms")
            ),
            "host": pa.array(rng.choice([f"h{i}" for i in range(n_hosts)], n).tolist()),
            "path": pa.array(rng.choice([f"/p{i}" for i in range(12 * n_hosts)], n).tolist()),
            "status": pa.array(rng.choice([200.0, 301.0, 404.0, 500.0], n)),
            "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
            "lat": pa.array([None if z else float(v) for z, v in zip(null, lat)]),
            "x": pa.array(x),
        }
    )


@pytest.fixture(scope="module")
def tables() -> list[pa.Table]:
    # the group and distinct dictionaries grow block by block: capacity epochs
    return [stats_table(60 + i, 3000, card) for i, card in enumerate((2, 5, 40))]


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
    return ET.TpuQueryExecutor(jax_plan(jax_parse(sql)), opts).execute(iter(tables)).to_pylist()


def jax_cpu(sql: str, tables) -> list[dict]:
    return JaxCpuExecutor(jax_plan(jax_parse(sql))).execute(iter(tables)).to_pylist()


def port_cpu(sql: str, tables) -> list[dict]:
    return PortCpuExecutor(port_plan(port_parse(sql))).execute(iter(tables)).to_pylist()


# column alias prefix -> relative tolerance against (JAX "tpu", CPU engines);
# None = exact; "m" min/max: the same f32 value as JAX "tpu", f32 rounding
# of the value against the f64 CPU engines
PCT_TOL = {
    "c": (None, None), "d": (None, None), "m": (None, 2e-4), "s": (2e-4, 2e-4), "p": (1e-3, 0.06),
}


def assert_stats(ref: list[dict], got: list[dict], sql: str, engine: int) -> None:
    def key(r):
        return tuple(str(r[k]) for k in sorted(r) if k.startswith("g"))

    ref, got = sorted(ref, key=key), sorted(got, key=key)
    assert len(ref) == len(got) > 0, (sql, len(ref), len(got))
    for rr, rg in zip(ref, got):
        assert set(rr) == set(rg), sql
        for k, a in rr.items():
            b = rg[k]
            rel = PCT_TOL[k[0]][engine] if k[0] in PCT_TOL else None
            if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
                assert np.isnan(b), (sql, k, a, b)
            elif rel is None or a is None or b is None:
                assert a == b, (sql, k, a, b)
            else:
                assert b == pytest.approx(a, rel=rel, abs=1e-6), (sql, k, a, b)


STATS_CASES = {
    "moments": (
        "SELECT host AS g0, count(*) AS c0, stddev(lat) AS s0, var(bytes) AS s1, "
        "var(lat) AS s2, count(lat) AS c1 FROM t GROUP BY g0"
    ),
    "percentiles": (
        "SELECT status AS g0, approx_percentile_cont(x, 0.95) AS p0, approx_median(lat) AS p1, "
        "approx_percentile_cont(bytes, 0.01) AS p2, min(lat) AS m0, max(bytes) AS m1 "
        "FROM t GROUP BY g0"
    ),
    "distinct": (
        "SELECT host AS g0, count(distinct path) AS d0, approx_distinct(path) AS d1, "
        "approx_distinct(status) AS d2, count(*) AS c0 FROM t GROUP BY g0"
    ),
    "time-bins": (
        "SELECT date_bin(interval '10 minutes', p_timestamp) AS g0, stddev(lat) AS s0, "
        "count(distinct host) AS d0, approx_distinct(host) AS d1, "
        "approx_percentile_cont(x, 0.5) AS p0 FROM t WHERE status >= 300 GROUP BY g0"
    ),
    "no-group": (
        "SELECT count(*) AS c0, stddev(bytes) AS s0, approx_percentile_cont(lat, 0.9) AS p0, "
        "count(distinct host) AS d0 FROM t"
    ),
}


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_p0_p100_exact_at_f32(p):
    rng = np.random.default_rng(17)
    v = rng.random(9_000) * 777.7 - 100
    sql = f"SELECT approx_percentile_cont(v, {p}) AS p FROM t"
    got, routes = port_gpu(sql, [pa.table({"v": pa.array(v)})])
    assert routes["cpu_fallback"] == 0
    want = float(np.float32(v.min() if p == 0.0 else v.max()))
    assert got[0]["p"] == pytest.approx(want, rel=1e-6)


def test_percentiles_past_the_histogram_budget_take_the_cpu_engine(monkeypatch, tables):
    """Past PCT_MAX_ELEMS both packages fold the whole scan on the host."""
    monkeypatch.setattr(X, "PCT_MAX_ELEMS", 100)
    monkeypatch.setattr(ET, "PCT_MAX_ELEMS", 100)
    sql = "SELECT host AS g0, approx_percentile_cont(lat, 0.5) AS p0 FROM t GROUP BY g0"
    got, routes = port_gpu(sql, tables)
    assert routes["device_cold"] == 0 and routes["cpu_fallback"] == len(tables), routes
    assert_stats(jax_cpu(sql, tables), got, sql, 1)
    assert_stats(jax_tpu(sql, tables), got, sql, 1)


def test_stats_wrappers_compute_plain_on_cpu_and_check_inputs():
    """On CPU tensors the wrappers fold their plain versions in place and
    launch nothing; bad inputs raise KernelError before any launch."""
    before = dict(SC.LAUNCHES)
    n, g = 100, 4
    ids = torch.arange(n, dtype=torch.int32) % g
    mask = torch.ones(n, dtype=torch.bool)
    acc = torch.zeros(g * 8)
    assert SC.distinct_fold(acc, ids, torch.zeros(n, dtype=torch.int8), mask, 8) is acc
    assert acc.sum() == g
    hist = torch.zeros(g * SC.DEVICE_NB)
    SC.pct_histogram(hist, torch.ones(n), ids, mask)
    assert hist.sum() == n
    assert SC.centered_m2(ids, torch.ones((1, n)), mask[None], mask, torch.ones((1, g))).sum() == 0
    # a forced regime on CPU tensors computes the plain version too
    codes = (torch.arange(n) % 8).to(torch.int8)
    compact = SC.distinct_fold(torch.zeros(g * 8), ids, codes, mask, 8, regime="compact")
    assert torch.equal(compact, SC.distinct_fold_plain(torch.zeros(g * 8), ids, codes, mask, 8))
    vals = torch.linspace(-3, 700, n)
    SC.pct_histogram(hist, vals, ids, mask, regime="compact")
    ones = SC.pct_histogram_plain(torch.zeros(g * SC.DEVICE_NB), torch.ones(n), ids, mask)
    assert torch.equal(hist, SC.pct_histogram_plain(ones, vals, ids, mask))
    assert SC.LAUNCHES == before
    with pytest.raises(SC.KernelError):  # a regime the wrappers do not know
        SC.distinct_fold(acc, ids, codes, mask, 8, regime="private")
    with pytest.raises(SC.KernelError):
        SC.pct_histogram(hist, vals, ids, mask, regime="bitmap")
    with pytest.raises(SC.KernelError):  # float codes
        SC.distinct_fold(acc, ids, torch.zeros(n), mask, 8)
    with pytest.raises(SC.KernelError):  # accumulator not a multiple of cap
        SC.distinct_fold(torch.zeros(10), ids, torch.zeros(n, dtype=torch.int8), mask, 8)
    with pytest.raises(SC.KernelError):  # int64 ids
        SC.pct_histogram(hist, torch.ones(n), ids.long(), mask)
    with pytest.raises(SC.KernelError):  # mean of another row count
        SC.centered_m2(ids, torch.ones((1, n)), mask[None], mask, torch.ones((2, g)))
    with pytest.raises(SC.KernelError):  # tensors on two devices
        SC.pct_histogram(hist, torch.ones(n, device="meta"), ids, mask)


@pytest.mark.parametrize(
    "rule,args,regime",
    [
        ("distinct", (8, 128), "compact"), ("distinct", (64, 128), "compact"),
        ("distinct", (65, 128), "compact"), ("distinct", (8, 4096), "compact"),
        ("distinct", (64, 4096), "global"), ("distinct", (65536, 128), "global"),
        ("distinct", (65537, 128), "global"), ("distinct", (1 << 19, 32), "global"),
        ("distinct", (256, 128), "compact"), ("distinct", (257, 128), "global"),
        ("distinct", (2048, 4), "shared"), ("distinct", (1024, 32), "compact"),
        ("distinct", (64, 4096, True), "compact"), ("distinct", (8, 4096, True), "compact"),
        ("distinct", (65536, 16, True), "compact"), ("distinct", (65537, 16, True), "global"),
        ("pct", (24,), "compact"), ("pct", (25,), "compact"), ("pct", (8,), "compact"),
        ("pct", (64,), "compact"), ("pct", (8188,), "compact"), ("pct", (65537,), "global"),
        ("m2", (2, 64), "shared"), ("m2", (2, 65536), "global"),
        ("m2", (2, 8), "compact"), ("m2", (1, 16), "compact"), ("m2", (1, 17), "shared"),
        ("m2", (3, 4), "shared"),
    ],
)
def test_statistics_regime_rules(rule, args, regime):
    assert getattr(SC, f"{rule}_regime")(*args) == regime
