"""The hand CUDA kernels against their plain versions, on a card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). On a CUDA machine: `python -m pytest tests/test_torch_cuda.py`.
The file imports no JAX, so it runs where only the port's dependencies
are installed. Tolerances: counts exact (f32 adds of 0/1 below 2^24),
sums rel 2e-4 (atomics add in a varying order), min/max exact.
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
def test_cuda_executor_matches_plain_path(cuda, sql):
    """The executor on the card against the same executor on the CPU (the
    kernels' plain versions): the whole fold, not only the kernels."""
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    tables = [
        _table(s, 20_000).replace_schema_metadata({SOURCE_ID_META: str(s).encode()})
        for s in (1, 2)
    ]
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
