"""The hand CUDA kernels against their plain versions, on a card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). On a CUDA machine: `python -m pytest tests/test_torch_cuda.py`.
The file imports no JAX, so it runs where only the port's dependencies
are installed. Tolerances: counts exact (f32 adds of 0/1 below 2^24),
sums rel 2e-4 (atomics add in a varying order), min/max exact; of the
statistics kernels, K5 (distinct presence, HLL registers) and K6
(percentile histograms) bit for bit, K7 (centred second moments) rel 2e-4
of its f64 plain version; K8 (the device top-k) bit for bit in its ids and
its gather.
"""

import numpy as np
import pytest
import torch

from parseable_tpu_torch.ops import groupby_cuda as G

SUM_TOL = dict(rtol=2e-4, atol=1e-6)


def _block(seed: int, n: int, g: int, n_sum: int, n_min: int, n_max: int, n_cnt: int,
           id_span: int | None = None, dead_group: int | None = None):
    """Inputs of one block: ids in [0, id_span) (groups past it stay empty),
    a mask that is all False on `dead_group`, and values/validity rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, id_span or g, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    if dead_group is not None:
        mask[ids == dead_group] = False
    n_all = n_sum + n_min + n_max + n_cnt
    return dict(
        ids=ids,
        mask=mask,
        sums=(rng.random((n_sum, n)) * 1000).astype(np.float32),
        mins=(rng.standard_normal((n_min, n)) * 100).astype(np.float32),
        maxs=(rng.standard_normal((n_max, n)) * 100).astype(np.float32),
        valid=rng.random((n_all, n)) < 0.9,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("g", [128, 2048, 65536])
def test_cuda_additive_matches_plain(cuda, g):
    b = _block(11, 1 << 16, g, 2, 0, 0, 2)
    mask = torch.from_numpy(b["mask"])
    rows = torch.cat([mask[None].float(), torch.from_numpy(b["valid"]).float() * mask,
                      torch.from_numpy(b["sums"]) * mask]).to(cuda)
    ids = torch.from_numpy(b["ids"]).to(cuda)
    before = G.LAUNCHES["additive_groupby"]
    got = G.additive_groupby(ids, rows, g)
    assert G.LAUNCHES["additive_groupby"] == before + 1
    ref = G.additive_groupby_plain(ids, rows, g)
    torch.testing.assert_close(got[:5], ref[:5], rtol=0, atol=0)
    torch.testing.assert_close(got, ref, **SUM_TOL)


@pytest.mark.parametrize("g", [64, 65536])
def test_cuda_minmax_matches_plain(cuda, g):
    b = _block(13, 1 << 16, g, 0, 1, 2, 0, id_span=(3 * g) // 4, dead_group=1)
    args = [torch.from_numpy(x).to(cuda) for x in
            (b["ids"], np.concatenate([b["mins"], b["maxs"]]), b["valid"], b["mask"])]
    got = G.minmax_groupby(*args, g, 1)
    ref = G.minmax_groupby_plain(*args, g, 1)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def _table(seed: int, n: int):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    start = np.datetime64("2024-05-01T10:00:00", "ms")
    return pa.table(
        {
            "p_timestamp": pa.array(
                start + rng.integers(0, 3_600_000, n).astype("timedelta64[ms]"),
                pa.timestamp("ms"),
            ),
            "host": pa.array(rng.choice([f"h{i}" for i in range(40)], n)),
            "message": pa.array(rng.choice(["ok", "error: x", "slow"], n)),
            "status": pa.array(rng.choice([200.0, 404.0, 500.0], n)),
            "lat": pa.array(rng.random(n) * 100),
        }
    )


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, status, count(*) AS c, "
        "sum(lat) AS s FROM t GROUP BY t, status",
        "SELECT host, min(lat) AS mn, max(lat) AS mx FROM t "
        "WHERE message LIKE '%error%' AND status >= 400 GROUP BY host",
    ],
)
def test_cuda_executor_matches_plain_path(cuda, sql, monkeypatch):
    """The executor on the card against the same executor on the CPU (the
    kernels' plain versions): the whole fold, not only the kernels."""
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    tables = [
        _table(s, 20_000).replace_schema_metadata({SOURCE_ID_META: str(s).encode()})
        for s in (1, 2)
    ]
    # made-up source ids: an empty hot set, and no encoded-block cache
    get_hotset().clear()
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    before = dict(G.LAUNCHES)
    on_card = GpuQueryExecutor(plan(parse_sql(sql)), device=cuda)
    got = on_card.execute(iter(tables)).to_pylist()
    assert on_card.route_stats["cpu_fallback"] == 0
    assert G.LAUNCHES["additive_groupby"] == before["additive_groupby"] + 2
    ref = GpuQueryExecutor(plan(parse_sql(sql)), device="cpu").execute(iter(tables)).to_pylist()
    key = lambda r: tuple(str(r[k]) for k in ("t", "status", "host") if k in r)  # noqa: E731
    got, ref = sorted(got, key=key), sorted(ref, key=key)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        for k in a:
            if k in ("s",):
                assert a[k] == pytest.approx(b[k], rel=2e-4, abs=1e-6)
            else:
                assert a[k] == b[k], (k, a[k], b[k])


# ------------------------------------------------------------ every regime

A_REGIMES = [
    ("tensor", 3, 8), ("tensor", 5, 64), ("tensor", 5, 128), ("tensor", 1, 16),
    ("shared", 5, 2048), ("shared", 3, 8192), ("shared", 3, 64), ("shared", 12, 100),
    ("global", 5, 65536), ("global", 12, 100),
    # the block-local fold's group counts
    ("global", 1, 1 << 17), ("global", 3, 1 << 20), ("global", 4, 1 << 20), ("global", 5, 1 << 17),
    ("global", 8, 1 << 22), ("global", 3, 1 << 22),
]


def _rows(rng, ids, r):
    """Rows as the main path builds them: mask, 0/1 validity, masked sums."""
    n = ids.shape[0]
    mask = rng.random(n) < 0.9
    n_valid = (r - 1) // 2
    return np.concatenate(
        [
            mask[None].astype(np.float32),
            (rng.random((n_valid, n)) < 0.8).astype(np.float32) * mask,
            (rng.random((r - 1 - n_valid, n)) * 50_000).astype(np.float32) * mask,
        ]
    )


def _assert_additive(got, ref, rows):
    counts = ((rows == 0) | (rows == 1)).all(dim=1)
    torch.testing.assert_close(got[counts], ref[counts], rtol=0, atol=0)
    torch.testing.assert_close(got, ref, equal_nan=True, **SUM_TOL)


@pytest.mark.parametrize("n", [1 << 16, 70_001])  # 70,001: ragged, unaligned rows
@pytest.mark.parametrize("regime,r,g", A_REGIMES, ids=[f"{a}-R{b}-G{c}" for a, b, c in A_REGIMES])
def test_cuda_additive_regime_matches_plain(cuda, regime, r, g, n):
    rng = np.random.default_rng(g + n)
    ids = rng.integers(0, g, n).astype(np.int32)
    rows = torch.from_numpy(_rows(rng, ids, r)).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = G.additive_groupby(ids, rows, g, regime=regime)
    _assert_additive(got, G.additive_groupby_plain(ids, rows, g), rows)


@pytest.mark.parametrize("skew", ["one-group", "five-groups-half-in-one"])
@pytest.mark.parametrize("regime,r,g", A_REGIMES, ids=[f"{a}-R{b}-G{c}" for a, b, c in A_REGIMES])
def test_cuda_additive_skewed_ids(cuda, regime, r, g, skew):
    """The main path's skew: a time-bin key constant in a block, status 200
    for half of the rows."""
    rng = np.random.default_rng(5)
    n = 1 << 17
    if skew == "one-group":
        ids = np.full(n, g - 1, dtype=np.int32)
    else:
        live = rng.choice(g, 5, replace=False)
        ids = np.where(rng.random(n) < 0.5, live[0], rng.choice(live, n)).astype(np.int32)
    rows = torch.from_numpy(_rows(rng, ids, r)).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = G.additive_groupby(ids, rows, g, regime=regime)
    _assert_additive(got, G.additive_groupby_plain(ids, rows, g), rows)


@pytest.mark.parametrize("regime,r,g", A_REGIMES, ids=[f"{a}-R{b}-G{c}" for a, b, c in A_REGIMES])
def test_cuda_additive_out_of_range_nonfinite_and_f32_max(cuda, regime, r, g):
    """Ids outside [0, G) dropped; NaN and +-inf stay in their own groups
    (in the tensor regime a one-hot product would spread them); +-3.4e38
    values add like any other."""
    rng = np.random.default_rng(9)
    n = 1 << 16
    ids = rng.integers(0, g, n).astype(np.int32)
    ids[::31] = -1
    ids[::37] = g
    ids[::41] = 1 << 30
    rows = _rows(rng, ids, r)
    rows[-1, 100], rows[-1, 200], rows[-1, 300] = np.nan, np.inf, -np.inf
    ids[100], ids[200], ids[300] = 0, (1 % g), (2 % g)
    rows[-1, 400], rows[-1, 500] = 3.4e38, -3.4e38
    rows = torch.from_numpy(rows).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = G.additive_groupby(ids, rows, g, regime=regime)
    ref = G.additive_groupby_plain(ids, rows, g)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert int(torch.isnan(got).sum()) <= 1  # the NaN poisons its own group only
    _assert_additive(got, ref, rows)


def test_cuda_additive_refuses_a_regime_that_does_not_fit(cuda):
    ids = torch.zeros(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(G.KernelError):
        G.additive_groupby(ids, torch.ones((9, 1024), device=cuda), 8, regime="tensor")
    with pytest.raises(G.KernelError):
        G.additive_groupby(ids, torch.ones((5, 1024), device=cuda), 65536, regime="shared")


@pytest.mark.parametrize("decode", ["kernel", "launch"])
@pytest.mark.parametrize("skew", ["uniform", "one-group", "five-groups-half-in-one"])
@pytest.mark.parametrize("g", [64, 2048, 8192, 65536])  # shared, then global at 65536
def test_cuda_minmax_regimes_exact(cuda, g, skew, decode):
    rng = np.random.default_rng(g)
    n = 1 << 17
    if skew == "uniform":
        ids = rng.integers(0, (3 * g) // 4, n)
    elif skew == "one-group":
        ids = np.full(n, 1)
    else:
        live = rng.choice(g, 5, replace=False)
        ids = np.where(rng.random(n) < 0.5, live[0], rng.choice(live, n))
    ids = ids.astype(np.int32)
    ids[::97], ids[::89] = -1, g
    vals = (rng.standard_normal((3, n)) * 1000).astype(np.float32)
    vals[0, ::1001], vals[2, ::1003] = 3.4e38, -3.4e38
    vals[1, 7], vals[2, 9] = np.inf, -np.inf
    args = [torch.from_numpy(x).to(cuda) for x in
            (ids, vals, rng.random((3, n)) < 0.8, rng.random(n) < 0.7)]
    for n_min in (0, 1, 3):
        got = G.minmax_groupby(*args, g, n_min, decode=decode)
        ref = G.minmax_groupby_plain(*args, g, n_min)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1 << 16, 70_001])  # 70,001: ragged, unaligned rows
@pytest.mark.parametrize("g", [64, 65536])
def test_cuda_minmax_more_rows_than_registers_hold(cuda, g, n):
    """K = 10 value rows: the first 4 are held in registers, the rest loaded
    as they fold."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(0, g, n).astype(np.int32),
        (rng.standard_normal((10, n)) * 100).astype(np.float32),
        rng.random((10, n)) < 0.8, rng.random(n) < 0.9)]
    for a, b in zip(G.minmax_groupby(*args, g, 4), G.minmax_groupby_plain(*args, g, 4)):
        assert torch.equal(a, b)


# --------------------------------------------- K5-K7: the dense fold's statistics


def _stat_ids(rng, n: int, g: int, skew: str) -> np.ndarray:
    """Ids of `skew`: uniform, one crowded group, or five groups with half
    of the rows in one; a few ids out of range either way."""
    if skew == "uniform":
        ids = rng.integers(0, g, n)
    elif skew == "one-group":
        ids = np.full(n, g - 1)
    else:
        live = rng.choice(g, min(5, g), replace=False)
        ids = np.where(rng.random(n) < 0.5, live[0], rng.choice(live, n))
    ids = ids.astype(np.int32)
    ids[::97], ids[::89] = -1, g
    return ids


SKEWS = ["uniform", "one-group", "five-groups-half-in-one"]
K5_CASES = [  # (G, cap, hll, regime)
    (8, 128, False, "shared"), (64, 128, False, "shared"), (2048, 512, False, "global"),
    (8, 4096, True, "shared"), (64, 4096, True, "global"), (4, 16, False, "global"),
    # compact: on uniform ids the CTAs of G = 2048 x 512 and of 8 x 4096 HLL
    # touch more groups than their copy holds and fold with global atomics
    (8, 128, False, "compact"), (64, 128, False, "compact"), (2048, 512, False, "compact"),
    (8, 4096, True, "compact"), (64, 4096, True, "compact"), (4, 16, False, "compact"),
]


@pytest.mark.parametrize("code_dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("g,cap,hll,regime", K5_CASES,
                         ids=[f"G{a}-cap{b}-{'hll' if c else 'presence'}-{d}" for a, b, c, d in K5_CASES])
def test_cuda_distinct_fold_exact(cuda, g, cap, hll, regime, skew, code_dtype):
    """K5 bit for bit against its plain version, folding two blocks into
    the same accumulator; codes past the LUT drop."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(g + cap)
    n, v = 70_001, min(100, np.iinfo(code_dtype).max)
    acc = torch.zeros(g * cap, device=cuda)
    ref = acc.clone()
    for _ in range(2):
        ids = torch.from_numpy(_stat_ids(rng, n, g, skew)).to(cuda)
        codes = rng.integers(0, v + 3, n).astype(code_dtype)  # v, v+1, v+2: past the LUT
        codes = torch.from_numpy(codes).to(cuda)
        mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
        if hll:
            lut = np.stack([rng.integers(0, cap, v), rng.integers(0, 54, v)]).astype(np.int32)
        else:
            lut = rng.integers(0, cap + 4, v).astype(np.int32)  # past cap: clamps to cap - 1
        lut = torch.from_numpy(lut).to(cuda)
        before = SC.LAUNCHES["distinct_fold"]
        SC.distinct_fold(acc, ids, codes, mask, cap, lut, regime=regime)
        assert SC.LAUNCHES["distinct_fold"] == before + 1
        ref = SC.distinct_fold_plain(ref, ids, codes, mask, cap, lut)
    assert torch.equal(acc, ref)


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("g,regime", [(1, "shared"), (8, "shared"), (24, "shared"), (8, "global"),
                                      (64, "global"), (2048, "global"), (1, "compact"),
                                      (8, "compact"), (64, "compact"), (2048, "compact")])
def test_cuda_pct_histogram_exact(cuda, g, regime, skew):
    """K6 bin for bin against its plain version (the same f32 log2 on the
    card): NaN dropped, +-inf and +-3.4e38 in the extreme bins, zeros in
    their own slot, negatives on their side; two blocks into one acc."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(g)
    n = 70_001
    acc = torch.zeros(g * SC.DEVICE_NB, device=cuda)
    ref = acc.clone()
    for _ in range(2):
        vals = (rng.random(n) * 500).astype(np.float32)
        vals[::7] *= -1
        vals[::11] = 0.0
        vals[::13] = np.exp(rng.normal(0, 20, len(vals[::13]))).astype(np.float32)
        vals[5], vals[6], vals[7], vals[8], vals[9] = np.nan, np.inf, -np.inf, 3.4e38, -3.4e38
        args = [torch.from_numpy(x).to(cuda) for x in
                (vals, _stat_ids(rng, n, g, skew), rng.random(n) < 0.8)]
        SC.pct_histogram(acc, *args, regime=regime)
        ref = SC.pct_histogram_plain(ref, *args)
    assert torch.equal(acc, ref)


def _pct_block(rng, n: int, g: int, skew: str):
    vals = (rng.random(n) * 500).astype(np.float32)
    vals[::7] *= -1
    vals[::11] = 0.0
    vals[5], vals[6], vals[7] = np.nan, np.inf, -3.4e38
    return vals, _stat_ids(rng, n, g, skew), rng.random(n) < 0.8


@pytest.mark.parametrize("offset", ["all", "vals", "ids", "mask"])
@pytest.mark.parametrize("regime", ["compact", "shared", "global"])
def test_cuda_pct_histogram_unaligned_inputs(cuda, regime, offset):
    """K6 on inputs that start one element past a 16-byte boundary: all of
    them (the compact regime's scalar head, then vector loads) or one (no
    common phase: scalar loads); N = 70,001 rows, a ragged tail."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(23)
    n, g = 70_001, 8
    full = [torch.from_numpy(x).to(cuda)
            for x in _pct_block(rng, n + 1, g, "five-groups-half-in-one")]
    names = ("vals", "ids", "mask")
    args = [t[1:] if offset in ("all", name) else t[:-1] for t, name in zip(full, names)]
    assert any(t.data_ptr() % 16 for t in args)
    acc = torch.zeros(g * SC.DEVICE_NB, device=cuda)
    SC.pct_histogram(acc, *args, regime=regime)
    assert torch.equal(acc, SC.pct_histogram_plain(torch.zeros_like(acc), *args))


@pytest.mark.parametrize("offset", ["all", "ids", "codes", "mask"])
@pytest.mark.parametrize("code_dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("hll", [False, True], ids=["presence", "hll"])
def test_cuda_distinct_fold_compact_unaligned_inputs(cuda, hll, code_dtype, offset):
    """K5's compact regime on inputs one element past a 16-byte boundary, all
    of them or one; N = 70,001 rows."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(29)
    n, g, cap, v = 70_001, 64, 4096 if hll else 128, 100
    ids = torch.from_numpy(_stat_ids(rng, n + 1, g, "five-groups-half-in-one")).to(cuda)
    codes = torch.from_numpy(rng.integers(0, v + 3, n + 1).astype(code_dtype)).to(cuda)
    mask = torch.from_numpy(rng.random(n + 1) < 0.8).to(cuda)
    lut = (np.stack([rng.integers(0, cap, v), rng.integers(0, 54, v)]) if hll
           else rng.integers(0, cap + 4, v))
    lut = torch.from_numpy(lut.astype(np.int32)).to(cuda)
    args = [t[1:] if offset in ("all", name) else t[:-1]
            for t, name in zip((ids, codes, mask), ("ids", "codes", "mask"))]
    acc = torch.zeros(g * cap, device=cuda)
    SC.distinct_fold(acc, *args, cap, lut, regime="compact")
    assert torch.equal(acc, SC.distinct_fold_plain(torch.zeros_like(acc), *args, cap, lut))


@pytest.mark.parametrize("g", [1, 64])
def test_cuda_pct_histogram_compact_bin_past_u16(cuda, g):
    """One group and one bin get 100,003 rows in one call: the compact
    regime's u16 counters hold a CTA's chunk (at most 8,192 rows), so the
    bin's count is exact in f32 however many CTAs add to it."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    n = 100_003
    vals = torch.full((n,), 300.0, device=cuda)
    ids = torch.full((n,), g - 1, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    acc = SC.pct_histogram(torch.zeros(g * SC.DEVICE_NB, device=cuda), vals, ids, mask,
                           regime="compact")
    assert acc.max().item() == n and int((acc != 0).sum()) == 1
    assert torch.equal(acc, SC.pct_histogram_plain(torch.zeros_like(acc), vals, ids, mask))


@pytest.mark.parametrize("n", [70_001, 3 * (1 << 20) + 5])
def test_cuda_compact_long_blocks(cuda, n):
    """K5 and K6 compact on a ragged block and on one long enough for two
    quads a thread and more CTAs than the card holds at once."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(n)
    vals, ids, mask = (torch.from_numpy(x).to(cuda) for x in _pct_block(rng, n, 64, "uniform"))
    ids = torch.where(ids >= 0, ids % 3 * 21, ids)  # three groups of 64, as a minute file
    acc = SC.pct_histogram(torch.zeros(64 * SC.DEVICE_NB, device=cuda), vals, ids, mask)
    assert torch.equal(acc, SC.pct_histogram_plain(torch.zeros_like(acc), vals, ids, mask))
    codes = torch.from_numpy(rng.integers(0, 100, n).astype(np.int8)).to(cuda)
    lut = torch.from_numpy(np.stack([rng.integers(0, 4096, 100), rng.integers(0, 54, 100)])
                           .astype(np.int32)).to(cuda)
    hll = SC.distinct_fold(torch.zeros(64 * 4096, device=cuda), ids, codes, mask, 4096, lut)
    want = SC.distinct_fold_plain(torch.zeros_like(hll), ids, codes, mask, 4096, lut)
    assert torch.equal(hll, want)


@pytest.mark.parametrize("g", [128, 2048])
def test_cuda_compact_partial_overflow(cuda, g):
    """Compact CTAs whose rows reach a few groups until the last eighth of
    each 4,096 rows spreads over all G: some warps finish their marks before
    the count passes what the copy holds and fold after the barrier, others
    stop marking and fold at once. K5 (HLL, presence) and K6 bit for bit."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(g)
    n = 1 << 20
    i = np.arange(n)
    ids = np.where(i % 4096 >= 3584, rng.integers(0, g, n), i // 4096 % 3).astype(np.int32)
    vals = (rng.random(n) * 500).astype(np.float32)
    mask = rng.random(n) < 0.9
    t_ids, t_vals, t_mask = (torch.from_numpy(x).to(cuda) for x in (ids, vals, mask))
    acc = SC.pct_histogram(torch.zeros(g * SC.DEVICE_NB, device=cuda), t_vals, t_ids, t_mask,
                           regime="compact")
    assert torch.equal(acc, SC.pct_histogram_plain(torch.zeros_like(acc), t_vals, t_ids, t_mask))
    codes = torch.from_numpy(rng.integers(0, 100, n).astype(np.int8)).to(cuda)
    for cap, lut in ((4096, np.stack([rng.integers(0, 4096, 100), rng.integers(0, 54, 100)])),
                     (128, rng.integers(0, 128, 100))):
        t_lut = torch.from_numpy(lut.astype(np.int32)).to(cuda)
        got = SC.distinct_fold(torch.zeros(g * cap, device=cuda), t_ids, codes, t_mask, cap, t_lut,
                               regime="compact")
        want = SC.distinct_fold_plain(torch.zeros_like(got), t_ids, codes, t_mask, cap, t_lut)
        assert torch.equal(got, want), cap


M2_CASES = [(1, 8, "shared"), (2, 64, "shared"), (3, 5000, "shared"),
            (2, 8, "global"), (2, 65536, "global"),
            (1, 8, "compact"), (2, 8, "compact"), (1, 16, "compact"), (2, 5, "compact"),
            # the block-local fold's group counts
            (1, 1 << 17, "global"), (1, 1 << 20, "global"), (2, 1 << 20, "global"),
            (1, 1 << 22, "global"), (3, 1 << 17, "global")]


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("q,g,regime", M2_CASES, ids=[f"Q{a}-G{b}-{c}" for a, b, c in M2_CASES])
def test_cuda_centered_m2_matches_f64(cuda, q, g, regime, skew):
    """K7 within rel 2e-4 of its f64 plain version; a NaN or +-inf value
    poisons its own group only."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(q * g)
    n = 70_001
    ids = _stat_ids(rng, n, g, skew)
    vals = (rng.random((q, n)) * 50_000).astype(np.float32)
    vals[0, ::1001] = 3.0e38 / 1e20  # large but finite squares stay in f32 range
    valid = rng.random((q, n)) < 0.9
    mask = rng.random(n) < 0.8
    args = [torch.from_numpy(x).to(cuda) for x in (ids, vals, valid, mask)]
    mean = torch.from_numpy((rng.random((q, g)) * 50_000).astype(np.float32)).to(cuda)
    got = SC.centered_m2(*args, mean, regime=regime)
    ref = SC.centered_m2_plain(*args, mean)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)
    vals[-1, 3], vals[-1, 4] = np.nan, np.inf
    ids[3], ids[4], valid[-1, 3:5], mask[3:5] = 0, min(1, g - 1), True, True
    args = [torch.from_numpy(x).to(cuda) for x in (ids, vals, valid, mask)]
    got = SC.centered_m2(*args, mean, regime=regime)
    ref = SC.centered_m2_plain(*args, mean)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert int(torch.isnan(got).sum()) <= 2
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("regime,g", [("compact", 8), ("global", 1 << 17)])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("offset", ["all", "ids", "vals", "none"])
def test_cuda_centered_m2_compact_unaligned_inputs(cuda, q, offset, regime, g):
    """K7's compact and global regimes on inputs one element past a 16-byte
    boundary: all of them (a scalar head of 3 rows, vector loads, a scalar
    tail of 1) or one (no common phase: scalar loads)."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(31 + q)
    n = 70_000
    ids = torch.from_numpy(_stat_ids(rng, n + 1, g, "five-groups-half-in-one")).to(cuda)
    mask = torch.from_numpy(rng.random(n + 1) < 0.8).to(cuda)
    flat_vals = torch.from_numpy((rng.random(q * n + 1) * 50_000).astype(np.float32)).to(cuda)
    flat_valid = torch.from_numpy(rng.random(q * n + 1) < 0.9).to(cuda)

    def part(t, name, rows=None):
        t = t[1:] if offset in ("all", name) else t[:-1]
        return t if rows is None else t.view(rows, n)

    args = [part(ids, "ids"), part(flat_vals, "vals", q), part(flat_valid, "vals", q),
            part(mask, "mask")]
    assert (args[0].data_ptr() % 16 != 0) == (offset in ("all", "ids"))
    mean = torch.from_numpy((rng.random((q, g)) * 50_000).astype(np.float32)).to(cuda)
    got = SC.centered_m2(*args, mean, regime=regime)
    torch.testing.assert_close(got, SC.centered_m2_plain(*args, mean), rtol=2e-4, atol=1e-6)


def test_cuda_centered_m2_compact_any_block_size_on_two_streams(cuda):
    """K7's compact regime on blocks of one CTA of scalar rows (5 rows) to
    256 CTAs, launched in turn on the current stream and on another one."""
    from parseable_tpu_torch.ops import stats_cuda as SC

    rng = np.random.default_rng(37)
    side = torch.cuda.Stream()
    for n, stream in ((1 << 20, None), (5, None), (70_001, side), (1 << 18, None), (4097, side)):
        q, g = 2, 8
        ids = torch.from_numpy(_stat_ids(rng, n, g, "uniform")).to(cuda)
        vals = torch.from_numpy((rng.random((q, n)) * 500).astype(np.float32)).to(cuda)
        valid = torch.from_numpy(rng.random((q, n)) < 0.9).to(cuda)
        mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
        mean = torch.from_numpy((rng.random((q, g)) * 500).astype(np.float32)).to(cuda)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got = SC.centered_m2(ids, vals, valid, mask, mean, regime="compact")
        torch.cuda.synchronize()
        want = SC.centered_m2_plain(ids, vals, valid, mask, mean)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("regime,q,g", [("shared", 2, 65536), ("compact", 2, 64), ("compact", 3, 4)])
def test_cuda_stats_refuse_a_regime_that_does_not_fit(cuda, regime, q, g):
    from parseable_tpu_torch.ops import stats_cuda as SC

    n = 1024
    ids = torch.zeros(n, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    with pytest.raises(G.KernelError):
        SC.pct_histogram(torch.zeros(64 * SC.DEVICE_NB, device=cuda), torch.ones(n, device=cuda),
                         ids, mask, regime="shared")
    with pytest.raises(G.KernelError):
        SC.distinct_fold(torch.zeros(64 * 4096, device=cuda), ids,
                         torch.zeros(n, dtype=torch.int8, device=cuda), mask, 4096, regime="shared")
    with pytest.raises(G.KernelError):
        SC.centered_m2(ids, torch.ones((q, n), device=cuda), mask[None].expand(q, n).contiguous(),
                       mask, torch.zeros((q, g), device=cuda), regime=regime)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT status, count(*) AS c, stddev(lat) AS sd, var(lat) AS v, "
        "approx_percentile_cont(lat, 0.99) AS p99, approx_median(lat) AS p50 FROM t GROUP BY status",
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, status, count(distinct host) AS h, "
        "approx_distinct(host) AS ah, approx_percentile_cont(lat, 0.5) AS p50 FROM t "
        "WHERE status >= 400 GROUP BY t, status",
    ],
    ids=["stddev-var-percentiles", "distinct-hll-percentile"],
)
def test_cuda_executor_statistics_match_plain_path(cuda, sql, monkeypatch):
    """The statistics' whole fold on the card against the same executor on
    the CPU: every new kernel launched, nothing on the CPU engine. stddev
    and var rel 2e-4 (f32 atomics in another order); percentiles rel 1e-3
    (the card's log2f and the CPU's log2 may put a value within an ulp of a
    bin edge into neighbouring bins, which moves the interpolation by a
    fraction of one bin over its count); counts and distincts exact."""
    from parseable_tpu_torch.ops import stats_cuda as SC
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    tables = [
        _table(s, 20_000).replace_schema_metadata({SOURCE_ID_META: str(s).encode()})
        for s in (1, 2)
    ]
    # made-up source ids: an empty hot set, and no encoded-block cache
    get_hotset().clear()
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    before = dict(SC.LAUNCHES)
    on_card = GpuQueryExecutor(plan(parse_sql(sql)), device=cuda)
    got = on_card.execute(iter(tables)).to_pylist()
    assert on_card.route_stats["cpu_fallback"] == 0
    launched = {k: SC.LAUNCHES[k] - before[k] for k in SC.LAUNCHES}
    assert launched["pct_histogram"] > 0, launched
    assert launched["centered_m2" if "stddev" in sql else "distinct_fold"] > 0, launched
    ref = GpuQueryExecutor(plan(parse_sql(sql)), device="cpu").execute(iter(tables)).to_pylist()
    key = lambda r: tuple(str(r[k]) for k in ("t", "status") if k in r)  # noqa: E731
    got, ref = sorted(got, key=key), sorted(ref, key=key)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        for k in a:
            if k in ("sd", "v"):
                assert a[k] == pytest.approx(b[k], rel=2e-4, abs=1e-6)
            elif k.startswith("p"):
                assert a[k] == pytest.approx(b[k], rel=1e-3)
            else:
                assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("budget_blocks", [None, 2.5], ids=["states", "pressure"])
def test_cuda_block_tiers_match_the_cpu_engine(cuda, tmp_path, monkeypatch, budget_blocks):
    """A lake on the card through the block tiers: cold, disk-warm and
    device-warm (hot set unbounded), or twice under a hot-set budget of 2.5
    blocks, where blocks are evicted and the prefetcher ships on its own
    CUDA stream. Every answer equals the CPU engine's (counts exact, sums
    rel 2e-4); no prefetch ship fails."""
    from datetime import UTC, datetime

    from parseable_tpu_torch.config import Options, StorageOptions
    from parseable_tpu_torch.core import Parseable
    from parseable_tpu_torch.ops.enccache import get_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    p = Parseable(Options(local_staging_path=tmp_path / "staging"),
                  StorageOptions(root=tmp_path / "data"))
    try:
        stream = p.create_stream_if_not_exists("t")
        for i in range(6):
            stream.write_parquet(_table(30 + i, 50_000), datetime(2024, 5, 1, 10, i, tzinfo=UTC))
        p.sync_all_streams()
        sql = ("SELECT date_bin(interval '1 minute', p_timestamp) AS t, status, count(*) AS c, "
               "sum(lat) AS s FROM t GROUP BY t, status")
        want = QuerySession(p, engine="cpu").query(sql).table.to_pylist()
        hs = get_hotset()
        hs.clear()
        runs = [QuerySession(p, engine="gpu", device=cuda).query(sql)]  # every block resident
        if budget_blocks is None:
            get_enccache(p.options).wait_idle()
            hs.clear()
            runs.append(QuerySession(p, engine="gpu", device=cuda).query(sql))  # disk-warm
            runs.append(QuerySession(p, engine="gpu", device=cuda).query(sql))  # device-warm
            assert runs[-1].stats["device_routes"]["device_warm"] == 6
        else:
            block = max(slot.entry.nbytes for slot in hs._entries.values())
            monkeypatch.setenv("P_TPU_HOT_BYTES", str(int(budget_blocks * block)))
            runs += [QuerySession(p, engine="gpu", device=cuda).query(sql) for _ in range(2)]
            hot = runs[-1].stats["stages"]["hotset"]
            assert hot["evictions"] > 0, hot
            assert sum(r.stats["device_routes"].get("prefetch_hits", 0) for r in runs) > 0
        key = lambda r: (str(r["t"]), r["status"])  # noqa: E731
        for res in runs:
            routes = res.stats["device_routes"]
            assert routes["cpu_fallback"] == 0 and routes.get("prefetch_errors", 0) == 0, routes
            got = sorted(res.table.to_pylist(), key=key)
            assert [(key(r), r["c"]) for r in got] == [(key(r), r["c"]) for r in sorted(want, key=key)]
            for a, b in zip(got, sorted(want, key=key)):
                assert a["s"] == pytest.approx(b["s"], rel=2e-4, abs=1e-6)
    finally:
        p.shutdown()
        get_hotset().clear()


# ------------------------------------------------------------ K3 (fold.cu)


def _k3_block(n: int, offset: int):
    """chip_smoke.py's K3 hazard block: int8/int16/int32 codes, f32 values
    with NaN, +-inf, -0.0 and NULLs, int32 times out to +-2^31 with NULLs,
    a padding mask, each a view `offset` elements off its buffer."""
    import chip_smoke

    return chip_smoke.k3_block(torch, np, n, offset, np.random.default_rng(3))


def _k3_programs():
    """chip_smoke.py's K3 programs: every opcode and operand row."""
    import chip_smoke

    from parseable_tpu_torch.ops import fold_cuda as F

    return chip_smoke.k3_programs(F, np, np.random.default_rng(4))


def _k3_run(prog, block):
    words = torch.from_numpy(prog.pack())
    words_cuda = words.cuda()
    slots = [(block[v] if v else None, block[m] if m else None) for v, m in prog.slots]
    cpu_slots = [tuple(t.cpu() if t is not None else None for t in s) for s in slots]
    return words, words_cuda, slots, cpu_slots


@pytest.mark.parametrize("n,offset", [(1 << 16, 0), (1 << 16, 2), (70_001, 1), (70_001, 3)])
def test_cuda_k3_matches_plain(cuda, n, offset):
    """K3a and K3b against their plain versions, bit for bit, over every
    opcode and hazard: IEEE compares on NaN, f64 compares next to their
    literals, floor division and wrapping int32 adds of the time key,
    sign-extended int8 codes, NULLs and NULL literals under three-valued
    connectives; in the kernels' 16-byte variant (offset 0) and in their
    scalar one (odd block sizes, views aligned to their element size
    only)."""
    from parseable_tpu_torch.ops import fold_cuda as F

    block = _k3_block(n, offset)
    assert F.vector_ok(n, list(block.values())) == (offset == 0)
    for name, prog in _k3_programs():
        words, words_cuda, slots, cpu_slots = _k3_run(prog, block)
        before = dict(F.LAUNCHES)
        mask, ids = F.mask_ids(words_cuda, slots, n)
        pmask, pids = F.mask_ids_plain(words, cpu_slots, n)
        assert F.LAUNCHES["mask_ids"] == before["mask_ids"] + 1
        assert torch.equal(mask.cpu(), pmask), name
        assert torch.equal(ids.cpu(), pids), name
        if prog.n_frows + prog.n_brows:
            frows, brows = F.stack_operands(words_cuda, slots, mask, prog.n_frows, prog.n_brows)
            pf, pb = F.stack_operands_plain(words, cpu_slots, pmask, prog.n_frows, prog.n_brows)
            assert torch.equal(frows.cpu().view(torch.int32), pf.view(torch.int32)), name
            assert torch.equal(brows.cpu(), pb), name
    assert 0 < int(mask.sum()) < n  # the last program's verdicts are mixed


def test_cuda_k3_launches_on_the_current_stream(cuda):
    """K3a and K3b enqueue on the caller's current stream: on a side stream
    that first waits behind a device spin, their outputs are still those
    of the plain versions once that stream is synchronized."""
    from parseable_tpu_torch.ops import fold_cuda as F

    n = 70_001
    block = _k3_block(n, 1)
    name, prog = _k3_programs()[-1]
    words, words_cuda, slots, cpu_slots = _k3_run(prog, block)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        mask, ids = F.mask_ids(words_cuda, slots, n)
        frows, brows = F.stack_operands(words_cuda, slots, mask, prog.n_frows, prog.n_brows)
    side.synchronize()
    pmask, pids = F.mask_ids_plain(words, cpu_slots, n)
    pf, pb = F.stack_operands_plain(words, cpu_slots, pmask, prog.n_frows, prog.n_brows)
    assert torch.equal(mask.cpu(), pmask) and torch.equal(ids.cpu(), pids)
    assert torch.equal(frows.cpu().view(torch.int32), pf.view(torch.int32))
    assert torch.equal(brows.cpu(), pb)


def test_cuda_k3_refuses_bad_inputs_and_a_failed_build(cuda, tmp_path, monkeypatch):
    """A CUDA tensor never falls back to the plain version: inputs the
    kernel does not take, and a library that does not build, raise
    KernelError."""
    from parseable_tpu_torch.ops import cuda_lib
    from parseable_tpu_torch.ops import fold_cuda as F

    block = _k3_block(1000, 0)
    name, prog = _k3_programs()[0]
    words, words_cuda, slots, _ = _k3_run(prog, block)
    with pytest.raises(F.KernelError):  # the program on the host, the columns on the card
        F.mask_ids(words, slots, 1000)
    with pytest.raises(F.KernelError):  # a column of another length
        F.mask_ids(words_cuda, [(block["c8"][:999], None)], 1000)
    broken = tmp_path / "csrc"
    broken.mkdir()
    (broken / "fold.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(cuda_lib, "CSRC", broken)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(F, "LIBRARY", cuda_lib.CudaLibrary("fold.cu", F._bind))
    with pytest.raises(F.KernelError, match="nvcc failed"):
        F.mask_ids(words_cuda, slots, 1000)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT p_timestamp, host, message, status FROM t WHERE status >= 404 "
        "AND message LIKE '%error%' ORDER BY p_timestamp DESC LIMIT 100",
        "SELECT host, lat FROM t WHERE host IN ('h1', 'h7') AND NOT (lat > 50) AND lat <> 3",
    ],
)
def test_cuda_select_matches_plain_path(cuda, sql, monkeypatch):
    """The select path on the card (K3a's mask, read back, rows filtered on
    the host) against the same executor on the CPU, row for row."""
    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    tables = [
        _table(s, 20_001).replace_schema_metadata({SOURCE_ID_META: f"s{s}".encode()})
        for s in (1, 2)
    ]
    get_hotset().clear()
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    before = F.LAUNCHES["mask_ids"]
    on_card = GpuQueryExecutor(plan(parse_sql(sql)), device=cuda)
    got = on_card.execute(iter(tables)).to_pylist()
    routes = on_card.route_stats
    assert routes["cpu_fallback"] == 0 and routes["device_cold"] == 2, routes
    assert F.LAUNCHES["mask_ids"] == before + 2
    assert routes["d2h_bytes"] == 2 * 32768  # one byte a row of each padded block
    ref = GpuQueryExecutor(plan(parse_sql(sql)), device="cpu").execute(iter(tables)).to_pylist()
    if "ORDER BY" not in sql:
        got, ref = (sorted(x, key=lambda r: tuple(map(repr, r.values()))) for x in (got, ref))
    assert len(got) > 0 and got == ref


# ------------------------------------------------- K8 (topk.cu), high cardinality


def _k8_exact(K, acc, kind, rows, desc, k, regime=None):
    """One K8 call against its plain version, bit for bit in the ids and the
    gathered f32 bits; one launch counted."""
    args = (acc, kind, *rows, desc, k)
    before = K.LAUNCHES["topk_groups"]
    out, idx = K.topk_groups(*args, regime=regime)
    assert K.LAUNCHES["topk_groups"] == before + 1
    pout, pidx = K.topk_groups_plain(*args)
    assert torch.equal(idx, pidx), (kind, desc, k, regime)
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32)), (kind, desc, k, regime)


@pytest.mark.parametrize("g", [8192, 8193, 3 * 2**15 + 7, 1 << 17, 1 << 19])
def test_cuda_topk_groups_exact_on_the_hazard_set(cuda, g):
    """K8 against its plain version, bit for bit in the ids and the gather:
    ties at the cut, NaN, +-inf, +-3.4e38, +-0.0 and subnormal keys, NULL
    aggregates and empty slots, every kind, both orders, k from 1 to 4,096
    (both sides of the regime boundary), in every regime that takes the
    shape, on G that the block regime's grid cuts evenly and unevenly."""
    import chip_smoke
    from parseable_tpu_torch.ops import topk_cuda as K

    acc = torch.from_numpy(chip_smoke.topk_hazard_acc(np, np.random.default_rng(g), 12, g, 5))
    acc = acc.to(cuda)
    for kind in K.KINDS:
        for desc in (True, False):
            for k in (1, 10, K.TOPK_BLOCK_MAX_K, K.TOPK_BLOCK_MAX_K + 1, K.TOPK_MAX_K):
                for regime in (None, *(r for r in K.REGIMES
                                       if r != "block" or k <= K.TOPK_BLOCK_MAX_K)):
                    _k8_exact(K, acc, kind, (6, 3, 9), desc, k, regime)


@pytest.mark.parametrize("g", [8193, 1 << 17])
def test_cuda_topk_groups_exact_on_ties_and_class_cuts(cuda, g):
    """Every score equal (the picks are the k lowest indices), and cuts
    inside the NaN keys, the NULL aggregates and the empty slots, in both
    regimes."""
    import chip_smoke
    from parseable_tpu_torch.ops import topk_cuda as K

    ties = torch.ones((3, g), dtype=torch.float32, device=cuda)
    classes, cuts = chip_smoke.topk_classes_acc(np, np.random.default_rng(g), g, (40, 30, 30))
    classes = torch.from_numpy(classes).to(cuda)
    for regime in K.REGIMES:
        for desc in (True, False):
            for k in (1, 10, K.TOPK_BLOCK_MAX_K):
                _k8_exact(K, ties, "sum", (2, 1, 0), desc, k, regime)
                _, idx = K.topk_groups(ties, "sum", 2, 1, 0, desc, k, regime=regime)
                assert idx.tolist() == list(range(k))
            for kind in ("sum", "avg", "count_star"):
                for k in cuts:
                    _k8_exact(K, classes, kind, (2, 1, 0), desc, k, regime)


def test_cuda_topk_block_regime_takes_its_largest_g(cuda):
    """The block regime at TOPK_BLOCK_MAX_G and TOPK_BLOCK_MAX_K (the largest
    slice and candidate buffer the rule gives it), and the rule's regime one
    group past it."""
    import chip_smoke
    from parseable_tpu_torch.ops import topk_cuda as K

    for g in (K.TOPK_BLOCK_MAX_G, K.TOPK_BLOCK_MAX_G + 1):
        acc = torch.from_numpy(chip_smoke.topk_hazard_acc(np, np.random.default_rng(g), 3, g, 2))
        acc = acc.to(cuda)
        for k in (10, K.TOPK_BLOCK_MAX_K):
            _k8_exact(K, acc, "sum", (2, 1, 0), True, k)


@pytest.mark.parametrize("kind", ["uniform", "minute-band", "near-unique", "one-hot-group", "outside"])
@pytest.mark.parametrize("g", [1 << 17, 1 << 20, 1 << 22])
def test_cuda_local_fold_regimes_at_large_g(cuda, g, kind):
    """The local fold's kernels at its group counts, on ids of each kind
    `chip_smoke.local_ids` makes: A in its "global" regime (R = 3 and 4), B
    with its decode launch, K7 in its "global" regime, against their plain
    versions (counts and min/max exact, sums and M2 rel 2e-4)."""
    import chip_smoke
    from parseable_tpu_torch.ops import stats_cuda as SC

    assert G.additive_regime(3, g) == "global" and G.minmax_decode(2, g) == "launch"
    assert SC.m2_regime(1, g) == "global"
    rng = np.random.default_rng(g)
    n = 1 << 20
    ids = chip_smoke.local_ids(torch, n, g, kind, torch.Generator().manual_seed(g))
    ids_np = ids.cpu().numpy()
    for r in (3, 4):
        rows = torch.from_numpy(_rows(rng, ids_np, r)).to(cuda)
        _assert_additive(G.additive_groupby(ids, rows, g), G.additive_groupby_plain(ids, rows, g),
                         rows)
    vals = torch.from_numpy((rng.standard_normal((2, n)) * 100).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((2, n)) < 0.9).to(cuda)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    got = G.minmax_groupby(ids, vals, valid, mask, g, 1)
    want = G.minmax_groupby_plain(ids, vals, valid, mask, g, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    mean = torch.from_numpy((rng.standard_normal((1, g)) * 10).astype(np.float32)).to(cuda)
    got = SC.centered_m2(ids, vals[:1].contiguous(), valid[:1].contiguous(), mask, mean)
    want = SC.centered_m2_plain(ids, vals[:1].contiguous(), valid[:1].contiguous(), mask, mean)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize(
    "sql,pairs",
    [
        ("SELECT a, count(*) AS c, sum(v) AS s, max(v) AS mx, stddev(v) AS sd FROM t GROUP BY a",
         False),
        ("SELECT a, b, count(*) AS c, sum(v) AS s, min(v) AS mn FROM t GROUP BY a, b", True),
    ],
    ids=["local", "pairs"],
)
def test_cuda_local_mode_matches_plain_path(cuda, sql, pairs, monkeypatch):
    """Local mode on the card (K3a KEY_CODE ids, K3b, A, B, K7 into a fresh
    block accumulator, one readback a block) against the same executor on
    the CPU: counts and min/max exact, sums and stddev rel 2e-4 (f32
    atomics in another order; the values are positive, so that no sum
    cancels to near zero, where a relative bound does not hold)."""
    import pyarrow as pa

    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query import executor_cuda as X
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    rng = np.random.default_rng(3)
    tables = [
        pa.table({"a": pa.array([f"a{int(x)}" for x in rng.integers(0, 3000, 1 << 16)]),
                  "b": pa.array([f"b{int(x)}" for x in rng.integers(0, 3000, 1 << 16)]),
                  "v": pa.array(rng.random(1 << 16) * 100)})
        .replace_schema_metadata({X.SOURCE_ID_META: f"local{i}".encode()})
        for i in range(2)
    ]
    get_hotset().clear()
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    # the gate off: both runs fold every block on their device (a profile
    # that learned a fast host rate, or the default one pricing local mode's
    # readback, would route these 65,536-row blocks to the host)
    monkeypatch.setenv("P_TPU_ADAPTIVE", "0")
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 10)
    monkeypatch.setattr(X, "LOCAL_G_MAX", 1 << 20)
    before = F.LAUNCHES["mask_ids"]
    on_card = X.GpuQueryExecutor(plan(parse_sql(sql)), device=cuda)
    got = on_card.execute(iter(tables)).to_pylist()
    r = on_card.route_stats
    assert (r["device_local"], r["cpu_fallback"]) == (2, 0), r
    assert F.LAUNCHES["mask_ids"] == before + 2
    get_hotset().clear()
    ref = X.GpuQueryExecutor(plan(parse_sql(sql)), device="cpu").execute(iter(tables)).to_pylist()
    key = lambda row: (row["a"], row.get("b"))  # noqa: E731
    got, ref = sorted(got, key=key), sorted(ref, key=key)
    assert len(got) == len(ref) > 0
    for x, y in zip(got, ref):
        for k in x:
            if k in ("s", "sd"):
                assert x[k] == pytest.approx(y[k], rel=2e-4, abs=1e-6)
            else:
                assert x[k] == y[k], (k, x[k], y[k])


# ----------------------------------------------------------- K10 mesh_combine


def _mesh_parts(seed: int, d: int, w: int, hazards: bool) -> tuple[torch.Tensor, list]:
    """[D, 7, W] partials of one accumulator layout (count | n | s | M2 |
    min | max | a flat SUM row): shard 0 empty where D > 1, the last group
    empty on every shard; with `hazards`, NaN, +-inf, +-3.4e38 and -0.0 in
    the MIN/MAX rows."""
    from parseable_tpu_torch.ops import mesh_cuda as MC

    rng = np.random.default_rng(seed)
    n = rng.integers(0, 100, (d, w)).astype(np.float32)
    if d > 1:
        n[0] = 0
    n[:, -1] = 0
    s = (rng.standard_normal((d, w)) * 10 + 5).astype(np.float32) * n
    m2 = (rng.random((d, w)) * 50).astype(np.float32) * (n > 1)
    mn = np.where(n > 0, rng.standard_normal((d, w)).astype(np.float32), np.float32(np.inf))
    mx = np.where(n > 0, rng.standard_normal((d, w)).astype(np.float32) + 3, np.float32(-np.inf))
    if hazards:
        pool = np.array([np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, -0.0, 0.0], np.float32)
        for row in (mn, mx):
            pick = rng.random((d, w)) < 0.05
            row[pick] = rng.choice(pool, int(pick.sum()))
    flat = rng.integers(0, 5, (d, w)).astype(np.float32)
    parts = np.stack([n, n, s, m2, mn, mx, flat], axis=1)
    desc = [(MC.SUM, 0, 0), (MC.SUM, 0, 0), (MC.SUM, 0, 0), (MC.M2, 1, 2), (MC.MIN, 0, 0),
            (MC.MAX, 0, 0), (MC.SUM, 0, 0)]
    return torch.from_numpy(parts), desc


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN matching any NaN."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("w", [1, 4099, 1 << 17])
@pytest.mark.parametrize("hazards", [False, True], ids=["plain", "hazards"])
def test_cuda_mesh_combine_exact(cuda, d, w, hazards):
    """K10 bit for bit against its plain version on the card, over every op,
    empty shards and groups, and NaN / +-inf / -0.0 in MIN and MAX rows."""
    from parseable_tpu_torch.ops import mesh_cuda as MC

    parts, desc = _mesh_parts(d * 31 + w, d, w, hazards)
    parts = parts.to(cuda)
    before = MC.LAUNCHES["mesh_combine"]
    got = MC.mesh_combine(parts, desc)
    torch.cuda.synchronize()
    assert MC.LAUNCHES["mesh_combine"] == before + 1
    assert _same_bits(got, MC.mesh_combine_plain(parts, desc))


def test_cuda_mesh_combine_refuses_bad_inputs(cuda):
    from parseable_tpu_torch.ops import mesh_cuda as MC

    parts = torch.zeros((2, 3, 64), device=cuda)
    with pytest.raises(G.KernelError):
        MC.mesh_combine(parts[:, :, ::2], [(MC.SUM, 0, 0)] * 3)  # not contiguous
    with pytest.raises(G.KernelError):
        MC.mesh_combine(parts, [(MC.M2, 7, 0)] * 3)


@pytest.mark.parametrize("shape", ["4", "2x2"])
def test_cuda_virtual_mesh_matches_one_device(cuda, shape, monkeypatch):
    """A virtual mesh on the one card (four shards on it, or 2 x 2 with a
    groups-sharded accumulator): every block folds sharded through K10, and
    the answers equal the one-device run's (counts and min/max exact, sums,
    stddev within rel 2e-4: another order of f32 sums)."""
    from parseable_tpu_torch.ops import mesh_cuda as MC
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, pin_mesh
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    sql = ("SELECT status, count(*) AS c, sum(lat) AS s, min(lat) AS mn, max(lat) AS mx, "
           "stddev(lat) AS sd, count(distinct host) AS h FROM t GROUP BY status")
    tables = [_table(s, 1 << 16).replace_schema_metadata({SOURCE_ID_META: f"m{s}".encode()})
              for s in (1, 2)]
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    monkeypatch.setenv("P_TPU_ADAPTIVE", "0")
    get_hotset().clear()
    one = GpuQueryExecutor(plan(parse_sql(sql)), device=cuda).execute(iter(tables)).to_pylist()
    mesh = make_mesh(4, devices=[cuda] * 4) if shape == "4" else make_mesh_2d(2, 2, [cuda] * 4)
    before = MC.LAUNCHES["mesh_combine"]
    with pin_mesh(mesh):
        ex = GpuQueryExecutor(plan(parse_sql(sql)), device=cuda)
        got = ex.execute(iter(tables)).to_pylist()
    assert ex.route_stats["device_mesh"] == 2 and ex.route_stats["cpu_fallback"] == 0
    assert MC.LAUNCHES["mesh_combine"] > before
    key = lambda r: str(r["status"])  # noqa: E731
    for a, b in zip(sorted(got, key=key), sorted(one, key=key)):
        for k in a:
            if k in ("s", "sd"):
                assert a[k] == pytest.approx(b[k], rel=2e-4, abs=1e-6)
            else:
                assert a[k] == b[k], (k, a[k], b[k])
    get_hotset().clear()
