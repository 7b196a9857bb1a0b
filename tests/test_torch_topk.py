"""K8, the device top-k, on the CPU: `ops/topk_cuda.topk_groups_plain` and
the GPU executor's `_run_topk_program` against the JAX package's
`_run_topk_program` (`parseable_tpu/query/executor_tpu.py:2165`, CPU JAX,
`lax.top_k`), on the same accumulator.

The accumulator is `chip_smoke.topk_hazard_acc`'s (the card's phase 10 runs
the same function): ties at every cut, NaN, +-inf, +-3.4e38 and +-0.0 keys,
NULL aggregates and empty slots, for every aggregate kind, in both orders,
and k from 1 to TOPK_MAX_K. No tolerance: the picked ids and the gathered
columns must be equal, the f32 bits of the gather included (both sides
compute each key with the same f32 divisions and square roots, and a pick
moves no value). Then ORDER BY <aggregate> LIMIT queries through the
port's "gpu" engine (`device="cpu"`) and the JAX "tpu" engine, with the
top-k threshold lowered in each, against the JAX CPU engine.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.ops import kernels as JK
from parseable_tpu.query import executor_tpu as ET
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.ops import kernels as PK
from parseable_tpu_torch.ops import topk_cuda as K
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from tests.test_torch_executor import jax_cpu, port_gpu

G = 8192
KINDS = [kind for _, kind in chip_smoke.TOPK_ITEMS]


class Side:
    """One package's executor, its aggregate specs and its AccLayout for
    `chip_smoke.TOPK_SQL`."""

    def __init__(self, ex, layout_cls):
        self.ex = ex
        self.specs = ex.build_aggregator()[0].specs
        self.lay = layout_cls.from_specs(self.specs)


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
def sides():
    opts = JaxOptions()
    opts.mesh_shape = "off"
    jax = Side(ET.TpuQueryExecutor(jax_plan(jax_parse(chip_smoke.TOPK_SQL)), opts), ET.AccLayout)
    port = Side(X.GpuQueryExecutor(port_plan(port_parse(chip_smoke.TOPK_SQL)), device="cpu"),
                X.AccLayout)
    assert [s.func for s in port.specs] == KINDS == [s.func for s in jax.specs]
    assert port.lay.n_rows == jax.lay.n_rows
    return jax, port


@pytest.fixture(scope="module")
def acc(sides) -> np.ndarray:
    # subnormals stay out of the JAX comparison: XLA's CPU runtime flushes
    # them to zero, which torch on the CPU and the card do not (the card's
    # set has them)
    lay = sides[1].lay
    return chip_smoke.topk_hazard_acc(np, np.random.default_rng(8), lay.n_rows, G,
                                      1 + lay.n_allk, subnormals=False)


def f32_bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32).view(np.int32)


def check_against_jax(sides, acc: np.ndarray, si: int, desc: bool, k: int) -> None:
    jax, port = sides
    jarr, jidx = jax.ex._run_topk_program(jnp.asarray(acc), si, desc, k, jax.lay, jax.specs)
    parr, pidx = port.ex._run_topk_program(torch.from_numpy(acc), si, desc, k, port.lay,
                                           port.specs)
    assert np.array_equal(pidx, jidx), (KINDS[si], desc, k)
    assert np.array_equal(f32_bits(parr), f32_bits(jarr)), (KINDS[si], desc, k)
    kind = KINDS[si]
    val, pac, sq = K.rows_for(port.lay, kind, si)
    out, idx = K.topk_groups_plain(torch.from_numpy(acc), kind, val, pac, sq, desc, k)
    assert np.array_equal(idx.numpy(), jidx)
    assert np.array_equal(out.numpy().view(np.int32), f32_bits(jarr))


@pytest.mark.parametrize("desc", [True, False], ids=["desc", "asc"])
@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_and_order_matches_jax(sides, acc, kind, desc):
    check_against_jax(sides, acc, KINDS.index(kind), desc, 10)


@pytest.mark.parametrize("k", [1, K.TOPK_MAX_K])
@pytest.mark.parametrize("kind,desc", [("sum", True), ("avg", False), ("stddev", True),
                                       ("count_star", False)])
def test_k_from_one_to_the_limit(sides, acc, kind, desc, k):
    check_against_jax(sides, acc, KINDS.index(kind), desc, k)


def test_the_score_map_orders_the_hazard_classes(sides, acc):
    """Real keys (-inf and -3.4e38 among them) above NaN keys, above NULL
    aggregates, above empty slots, in both orders; +-0.0 tie."""
    _, port = sides
    a = torch.from_numpy(acc)
    kind = "sum"
    val, pac, sq = K.rows_for(port.lay, kind, KINDS.index(kind))
    for desc in (True, False):
        score = K.scores_plain(a, kind, val, pac, sq, desc)
        v, live = a[val], (a[0] > 0) & (a[pac] > 0)
        real = score[live & ~torch.isnan(v)]
        assert real.min() > K.NAN_SCORE > K.NULL_SCORE > K.EMPTY_SCORE
        assert (score[live & torch.isnan(v)] == K.NAN_SCORE).all()
        assert (score[(a[0] > 0) & ~(a[pac] > 0)] == K.NULL_SCORE).all()
        assert (score[a[0] <= 0] == K.EMPTY_SCORE).all()
        for x, y in ((0.0, -0.0), (-np.inf, -3.4e38), (3.4e38, np.inf)):
            t = torch.tensor([[1.0, 1.0], [x, y]], dtype=torch.float32)
            sx, sy = K.scores_plain(t, "sum", 1, 0, 0, desc).tolist()
            assert (sx == sy) if x == y else ((sx < sy) == desc), (x, y, desc)


def test_topk_ties_go_to_the_lower_index():
    """kernels.topk orders as lax.top_k: larger first, lower index first
    among equal values."""
    rng = np.random.default_rng(4)
    v = rng.integers(-3, 3, 5000).astype(np.int32)
    for k in (1, 7, 100, 5000):
        jv, ji = JK.topk(jnp.asarray(v), k)
        pv, pi = PK.topk(torch.from_numpy(v), k)
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        assert np.array_equal(pv.numpy(), np.asarray(jv))


def test_the_wrapper_checks_its_inputs():
    a = torch.zeros((3, 16))
    for bad in (dict(kind="median"), dict(k=0), dict(k=17), dict(val_row=3)):
        args = dict(kind="sum", val_row=1, pac_row=1, sq_row=0, desc=True, k=4) | bad
        with pytest.raises(K.KernelError):
            K.topk_groups(a, **args)
    with pytest.raises(K.KernelError):
        K.topk_groups(a.double(), "sum", 1, 1, 0, True, 4)


# ------------------------------------------------------------ through the engines


@pytest.fixture(scope="module")
def dense_tables() -> list[pa.Table]:
    """tests/test_device_topk.py's inputs: two blocks, ~700 users (dense
    capacity 1,024), integer values, so that f32 sums are exact."""
    rng = np.random.default_rng(23)
    tables = []
    for _ in range(2):
        n = 20_000
        uid = rng.integers(0, 700, n)
        tables.append(pa.table({"user": pa.array([f"u{int(x):05d}" for x in uid]),
                                "v": pa.array(rng.integers(0, 100, n).astype(np.float64))}))
    return tables


@pytest.fixture
def low_topk_threshold(monkeypatch):
    """Both engines take the device top-k from 64 groups on, and the port's
    calls of K8 are counted."""
    monkeypatch.setattr(ET.TpuQueryExecutor, "TOPK_MIN_GROUPS", 64)
    monkeypatch.setattr(X.GpuQueryExecutor, "TOPK_MIN_GROUPS", 64)
    calls = []
    real = K.topk_groups

    def counted(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(K, "topk_groups", counted)
    return calls


def jax_tpu_rows(sql: str, tables) -> list[dict]:
    opts = JaxOptions()
    opts.mesh_shape = "off"
    return ET.TpuQueryExecutor(jax_plan(jax_parse(sql)), opts).execute(iter(tables)).to_pylist()


@pytest.mark.parametrize(
    "sql,pushed",
    [
        ("SELECT user, count(*) c, sum(v) s FROM t GROUP BY user ORDER BY s DESC LIMIT 10", True),
        ("SELECT user, sum(v) FROM t GROUP BY user ORDER BY sum(v) DESC LIMIT 4", True),
        ("SELECT user, max(v) mx, count(*) c FROM t GROUP BY user ORDER BY c DESC LIMIT 12", True),
        ("SELECT user, sum(v) s FROM t GROUP BY user HAVING sum(v) > 500 ORDER BY s DESC LIMIT 6",
         False),
        ("SELECT user, sum(v) s FROM t GROUP BY user ORDER BY user LIMIT 8", False),
    ],
    ids=["sum-desc", "aggcall-expr", "count-ties", "having", "order-by-key"],
)
def test_order_by_aggregate_limit_through_the_engines(dense_tables, low_topk_threshold, sql,
                                                      pushed):
    got, routes = port_gpu(sql, dense_tables)
    assert routes["cpu_fallback"] == 0, routes
    assert bool(low_topk_threshold) == pushed, low_topk_threshold
    assert got == jax_tpu_rows(sql, dense_tables)
    want = jax_cpu(sql, dense_tables)
    if " c DESC" not in sql:
        assert got == want
    else:  # ties on the count: the CPU engine picks any of the tied groups
        assert [r["c"] for r in got] == [r["c"] for r in want]


def test_avg_with_offset_and_asc(dense_tables, low_topk_threshold):
    for sql in ("SELECT user, avg(v) a FROM t GROUP BY user ORDER BY a DESC LIMIT 5 OFFSET 3",
                "SELECT user, count(*) c FROM t GROUP BY user ORDER BY c ASC LIMIT 5"):
        got, _ = port_gpu(sql, dense_tables)
        assert got == jax_tpu_rows(sql, dense_tables)
        col = "a" if "avg" in sql else "c"
        assert [r[col] for r in got] == pytest.approx([r[col] for r in jax_cpu(sql, dense_tables)],
                                                      rel=1e-6)
    assert len(low_topk_threshold) == 2


def test_null_aggregate_groups_survive(low_topk_threshold):
    """Groups whose ordering aggregate is NULL order last, and empty slots
    never displace them when LIMIT passes the non-NULL groups."""
    rng = np.random.default_rng(29)
    n = 5_000
    users = [f"u{int(x):03d}" for x in rng.integers(0, 100, n)]
    vals = [float(rng.integers(1, 50)) if u < "u050" else None for u in users]
    t = pa.table({"user": pa.array(users), "v": pa.array(vals, pa.float64())})
    sql = "SELECT user, sum(v) s FROM t GROUP BY user ORDER BY s DESC LIMIT 80"
    got, _ = port_gpu(sql, [t])
    assert low_topk_threshold
    assert got == jax_tpu_rows(sql, [t])
    assert len(got) == 80 and all(r["s"] is not None for r in got[:50])
    assert all(r["s"] is None for r in got[50:])


# ------------------------------------------------- the "block" regime's pick


def check_block_pick(acc: torch.Tensor, kind: str, rows: tuple, desc: bool, k: int,
                     size: int) -> None:
    """`topk_block_model` with slices of `size` groups against lax.top_k
    (CPU JAX) on the same int32 scores and against `topk_groups_plain`:
    the same ids, in the same order."""
    score = K.scores_plain(acc, kind, *rows, desc)
    got = K.topk_block_model(score, k, size)
    assert np.array_equal(got.numpy(), np.asarray(JK.topk(jnp.asarray(score.numpy()), k)[1]))
    _, idx = K.topk_groups_plain(acc, kind, *rows, desc, k)
    assert torch.equal(got, idx), (kind, desc, k, size)


def value_acc(values: np.ndarray) -> torch.Tensor:
    """count, pac and value rows: every slot occupied and not NULL."""
    acc = np.ones((3, values.size), np.float32)
    acc[2] = values
    return torch.from_numpy(acc)


# (G, k, groups a slice) of each case; the kernel's own grids where named so
GRID_G = (8193, 3 * 2**15 + 7)
BLOCK_CASES = {
    "ties-across-slices": (700, 25, 7),
    "all-equal": (1000, 100, 64),
    "ragged-last-slice": (1001, 37, 100),
    "k-above-a-slice": (600, 50, 16),
    "k-equals-g": (300, 300, 32),
    "one-slice": (500, 10, 500),
    "kernel-grid-8193": (GRID_G[0], 10, K.block_grid(GRID_G[0], 132)[1]),
    "kernel-grid-98311": (GRID_G[1], K.TOPK_BLOCK_MAX_K, K.block_grid(GRID_G[1], 132)[1]),
}


@pytest.mark.parametrize("desc", [True, False], ids=["desc", "asc"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_pick_matches_jax(case, desc):
    """Ties in runs of 9 that straddle slices of 7, every score equal (the
    picks are the k lowest indices), a last slice shorter than the rest, k
    above a slice's size, k == G, one slice, and the kernel's own grids at
    G that do not divide evenly."""
    g, k, size = BLOCK_CASES[case]
    rng = np.random.default_rng(g + k)
    if case == "ties-across-slices":
        values = np.repeat(rng.integers(0, 4, g // 9 + 1), 9)[:g]
    elif case == "all-equal":
        values = np.ones(g)
    else:
        values = rng.integers(0, 50, g)
    acc = value_acc(values.astype(np.float32))
    check_block_pick(acc, "sum", (2, 1, 0), desc, k, size)
    if case == "all-equal":
        assert torch.equal(K.topk_block_model(K.scores_plain(acc, "sum", 2, 1, 0, desc), k, size),
                           torch.arange(k, dtype=torch.int32))


@pytest.mark.parametrize("size", [37, K.block_grid(8193, 132)[1]], ids=["slice-37", "kernel-grid"])
@pytest.mark.parametrize("cut", ["nan", "null", "empty"])
@pytest.mark.parametrize("kind,desc", [("sum", True), ("avg", False)])
def test_block_pick_cuts_inside_each_hazard_class(kind, desc, cut, size):
    """The cut halfway into the NaN keys, the NULL aggregates and the empty
    slots, at k <= TOPK_BLOCK_MAX_K: below every real key, in that order,
    and the lower index first inside a class."""
    acc, cuts = chip_smoke.topk_classes_acc(np, np.random.default_rng(5), 8193, (40, 30, 30))
    k = cuts[("nan", "null", "empty").index(cut)]
    assert k <= K.TOPK_BLOCK_MAX_K
    acc = torch.from_numpy(acc)
    score = K.scores_plain(acc, kind, 2, 1, 0, desc)
    klass = {"nan": K.NAN_SCORE, "null": K.NULL_SCORE, "empty": K.EMPTY_SCORE}[cut]
    assert int((score > klass).sum()) < k < int((score >= klass).sum())
    check_block_pick(acc, kind, (2, 1, 0), desc, k, size)


def test_block_pick_on_the_hazard_set(sides, acc):
    """Every kind, both orders, at k = 1, 10 and TOPK_BLOCK_MAX_K, on the
    kernel's grid of G = 8,192 (16 slices of 512)."""
    _, port = sides
    a = torch.from_numpy(acc)
    size = K.block_grid(G, 132)[1]
    for si, kind in enumerate(KINDS):
        for desc in (True, False):
            for k in (1, 10, K.TOPK_BLOCK_MAX_K):
                check_block_pick(a, kind, K.rows_for(port.lay, kind, si), desc, k, size)


@pytest.mark.parametrize(
    "g,k,want",
    [(8192, 10, "block"), (1 << 17, 10, "block"), (1 << 17, K.TOPK_BLOCK_MAX_K, "block"),
     (1 << 17, K.TOPK_BLOCK_MAX_K + 1, "radix"), (1 << 17, K.TOPK_MAX_K, "radix"),
     (K.TOPK_BLOCK_MAX_G, 10, "block"), (K.TOPK_BLOCK_MAX_G + 1, 10, "radix"), (1, 1, "block")],
)
def test_topk_regime_rule(g, k, want):
    assert K.topk_regime(g, k) == want


@pytest.mark.parametrize("g", [1, 2, 511, 512, 513, 8192, 8193, 3 * 2**15 + 7, 1 << 17,
                               K.TOPK_BLOCK_MAX_G])
def test_block_grid_covers_every_group(g):
    """Every CTA of the grid gets at least one group and together they get
    all of them; on a card of 132 SMs a slice's scores and the merge's
    candidates at TOPK_BLOCK_MAX_K fit the kernel's shared-memory cap."""
    for sms in (1, 16, 132):
        ctas, size = K.block_grid(g, sms)
        assert 1 <= ctas <= sms and (ctas - 1) * size < g <= ctas * size
    ctas, size = K.block_grid(g, 132)
    assert max(4 * size, 8 * ctas * min(K.TOPK_BLOCK_MAX_K, size)) <= 200 * 1024


def test_the_wrapper_checks_its_regime():
    a = torch.zeros((3, 200))
    with pytest.raises(K.KernelError):
        K.topk_groups(a, "sum", 1, 1, 0, True, 4, regime="bitonic")
    with pytest.raises(K.KernelError):
        K.topk_groups(a, "sum", 1, 1, 0, True, K.TOPK_BLOCK_MAX_K + 1, regime="block")
    for regime in K.REGIMES:
        out, idx = K.topk_groups(a, "sum", 1, 1, 0, True, 4, regime=regime)
        assert out.shape == (3, 4) and idx.tolist() == [0, 1, 2, 3]
