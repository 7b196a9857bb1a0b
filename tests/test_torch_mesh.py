"""The port's device mesh (`parallel/mesh.py`, the GPU executor's mesh
branches and K10 `mesh_combine`) on the CPU.

The JAX package runs its mesh on conftest's 8 virtual CPU devices; the port
runs the same layouts on a device list that names the CPU several times
(a virtual mesh: the shards are views of one tensor), or names it as
"cpu:0".."cpu:7", which torch keeps apart as devices while the tensors
stay in host memory: that drives the per-card copies of a mesh over
several cards (one payload a card, partials copied to the combining
card). Inputs are made with numpy from a seed.

Tolerances:
- counts and distinct counts exact (f32 adds of 0/1, exact below 2^24);
- sums, averages, stddev/var rel 2e-4, abs 1e-6 (f32 per-shard sums
  against f64, and the order of summation over shards);
- min/max exact against another f32 path, rel 2e-4 against f64 engines;
- percentiles rel 0.06 (the bound PERF.md §2 uses between engines);
- `mesh_combine_plain` against a float64 oracle: SUM rel 1e-6 (D f32
  adds), M2 rel 1e-5 abs 1e-4 (f32 means and squares of O(1) values, n up
  to 100), MIN/MAX exact.
"""

from __future__ import annotations

import logging
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.parallel import mesh as JM
from parseable_tpu.query import executor_tpu as ET
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.config import Options
from parseable_tpu_torch.ops import fold_cuda as F
from parseable_tpu_torch.ops import mesh_cuda as MC
from parseable_tpu_torch.ops.hotset import get_hotset
from parseable_tpu_torch.parallel import mesh as PM
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse

BASE = datetime(2024, 5, 1, 10, 0)
TOL = dict(rel=2e-4, abs=1e-6)
PCT_REL = 0.06

# the port's meshes, by name: virtual (one device named several times) and
# over distinct devices ("cards")
MESHES = {
    "8": lambda: PM.make_mesh(8, devices=["cpu"] * 8),
    "4x2": lambda: PM.make_mesh_2d(4, 2, devices=["cpu"] * 8),
    "2x2": lambda: PM.make_mesh_2d(2, 2, devices=["cpu"] * 4),
    "4 cards": lambda: PM.make_mesh(4, devices=[f"cpu:{i}" for i in range(4)]),
    "2x2 cards": lambda: PM.make_mesh_2d(2, 2, devices=[f"cpu:{i}" for i in range(4)]),
}


@pytest.fixture(autouse=True)
def jax_program_cache():
    """The JAX engine's program cache as it was before the test: a program
    this file compiled would otherwise be a cache hit for a later test of
    the JAX package that counts the programs it builds."""
    before = set(ET._PROGRAM_CACHE)
    yield
    for key in set(ET._PROGRAM_CACHE) - before:
        del ET._PROGRAM_CACHE[key]


# ------------------------------------------------------- (a) parallel/mesh.py


def _inputs(n=1024, g=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    vals = rng.random((1, n)).astype(np.float32)
    valid = np.ones((1, n), dtype=bool)
    return ids, mask, vals, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mesh_name", ["8", "4 cards"])
def test_distributed_groupby_matches_jax(mesh_name):
    """test_parallel.py's first case: count and sums of the port's sharded
    step equal the JAX step's on its 8-device mesh."""
    n, g = 4096, 32
    ids, mask, vals, valid = _inputs(n, g)
    jmesh = JM.make_mesh(8)
    jstep = JM.distributed_groupby(jmesh, g, 1, 0, 0)
    empty = jnp.zeros((0, n), jnp.float32)
    sh = JM.shard_rows(jmesh, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vals),
                       jnp.asarray(valid))
    want = jstep(sh[0], sh[1], sh[2], empty, empty, sh[3])
    mesh = MESHES[mesh_name]()
    step = PM.distributed_groupby(mesh, g, 1, 0, 0)
    ti, tm, tv, tok = _t(ids, mask, vals, valid)
    e = torch.zeros((0, n), dtype=torch.float32)
    got = step(*PM.shard_rows(mesh, ti, tm, tv), e, e, PM.shard_rows(mesh, tok)[0])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    assert got[0].device.type == mesh.devices[0].type


def test_distributed_groupby_min_max_matches_jax():
    """test_parallel.py's min/max case: exact against the JAX pmin/pmax."""
    n, g = 2048, 8
    ids, mask, vals, valid = _inputs(n, g, seed=1)
    valid2 = np.concatenate([valid, valid])
    jmesh = JM.make_mesh(8)
    jstep = JM.distributed_groupby(jmesh, g, 0, 1, 1)
    empty = jnp.zeros((0, n), jnp.float32)
    sh = JM.shard_rows(jmesh, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vals),
                       jnp.asarray(valid2))
    want = jstep(sh[0], sh[1], empty, sh[2], sh[2], sh[3])
    mesh = MESHES["8"]()
    step = PM.distributed_groupby(mesh, g, 0, 1, 1)
    ti, tm, tv, tok = _t(ids, mask, vals, valid2)
    got = step(ti, tm, torch.zeros((0, n)), tv, tv, tok)
    present = np.asarray(want[0]) > 0
    for k in (3, 4):
        np.testing.assert_array_equal(got[k].numpy()[:, present], np.asarray(want[k])[:, present])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("mesh_name", ["2x2", "2x2 cards"])
def test_distributed_groupby_2d_shards_group_space(mesh_name):
    """test_parallel.py's 2D case (there 2 x 4): every window's counts,
    side by side, equal a host count and the JAX step's."""
    n, g = 4096, 64
    ids, mask, vals, valid = _inputs(n, g, seed=2)
    ref = np.bincount(ids[mask], minlength=g)
    mesh = MESHES[mesh_name]()
    per = g // mesh.n_groups
    step = PM.distributed_groupby_2d(mesh, per, 1, 0, 0)
    ti, tm, tv, tok = _t(ids, mask, vals, valid)
    e = torch.zeros((0, n), dtype=torch.float32)
    count, pac, sums, _, _ = step(ti, tm, tv, e, e, tok)
    assert tuple(count.shape) == (g,)
    np.testing.assert_array_equal(count.numpy(), ref)
    jmesh = JM.make_mesh_2d(2, 2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(jmesh, spec))  # noqa: E731
    want = JM.distributed_groupby_2d(jmesh, per, 1, 0, 0)(
        put(ids, P("data")), put(mask, P("data")), put(vals, P(None, "data")),
        put(np.zeros((0, n), np.float32), P(None, "data")),
        put(np.zeros((0, n), np.float32), P(None, "data")), put(valid, P(None, "data")))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want[2]), rtol=1e-5)


def test_full_query_step_matches_jax():
    """The complete sharded step (LUT mask, time-bin x host ids, fold,
    combine) against JAX's `full_query_step` on its 8-device mesh."""
    rng = np.random.default_rng(7)
    n, num_host, g = 8192, 6, 64
    rel = rng.integers(0, 3_600_000, n).astype(np.int32)
    status = rng.integers(0, 4, n).astype(np.int32)
    host = rng.integers(0, 8, n).astype(np.int32)
    lut = rng.random(8) < 0.6
    values = (rng.random(n) * 100).astype(np.float32)
    valid = rng.random(n) < 0.9
    jmesh = JM.make_mesh(8)
    jstep = JM.full_query_step(jmesh, g)
    want = jstep(*(jnp.asarray(a) for a in (rel, status, host, lut)), 600_000, num_host,
                 jnp.asarray(values), jnp.asarray(valid))
    mesh = MESHES["8"]()
    got = PM.full_query_step(mesh, g)(*_t(rel, status, host, lut), 600_000, num_host,
                                      *_t(values, valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-3)


# --------------------------------------------------- (b) K10's plain version


def _oracle(parts: np.ndarray, desc) -> np.ndarray:
    """K10's function in float64 numpy."""
    p = parts.astype(np.float64)
    out = np.empty(p.shape[1:])
    for r, (op, nr, sr) in enumerate(desc):
        if op == MC.SUM:
            out[r] = p[:, r].sum(axis=0)
        elif op in (MC.MIN, MC.MAX):
            out[r] = (np.min if op == MC.MIN else np.max)(p[:, r], axis=0)  # NaN propagates
        else:
            n, s = p[:, nr], p[:, sr]
            mean_t = s.sum(0) / np.maximum(n.sum(0), 1.0)
            mean_d = s / np.maximum(n, 1.0)
            term = p[:, r] + n * (mean_d - mean_t) ** 2
            out[r] = np.where(n > 0, term, 0.0).sum(axis=0)
    return out


def _moment_partials(rng, d: int, w: int, empty_shards: tuple = ()) -> np.ndarray:
    """Rows [count, n, s, M2, min, max] of D shards' real partials of the
    same values' per-group moments; `empty_shards` hold no rows, and group
    w - 1 is empty on every shard."""
    parts = np.zeros((d, 6, w), np.float32)
    for k in range(d):
        n = rng.integers(0, 100, w).astype(np.float32)
        if k in empty_shards:
            n[:] = 0
        n[-1] = 0
        for j in range(w):
            x = rng.normal(3.0, 2.0, int(n[j])).astype(np.float32)
            parts[k, 2, j] = x.sum(dtype=np.float32)
            parts[k, 3, j] = ((x - x.mean()) ** 2).sum(dtype=np.float32) if len(x) else 0.0
            parts[k, 4, j] = x.min() if len(x) else np.inf
            parts[k, 5, j] = x.max() if len(x) else -np.inf
        parts[k, 0], parts[k, 1] = n, n
    return parts


MOMENT_DESC = [(MC.SUM, 0, 0), (MC.SUM, 0, 0), (MC.SUM, 0, 0), (MC.M2, 1, 2), (MC.MIN, 0, 0),
               (MC.MAX, 0, 0)]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("empty", [(), (0,), "all but one"])
def test_mesh_combine_plain_moments(d, empty):
    """Every op of one accumulator layout, shards with n_d = 0 and a group
    empty on every shard: SUM and M2 against float64, MIN/MAX exact."""
    rng = np.random.default_rng(d * 10 + len(empty))
    shards = tuple(range(1, d)) if empty == "all but one" else empty
    parts = _moment_partials(rng, d, 33, shards)
    got = MC.mesh_combine(torch.from_numpy(parts), MOMENT_DESC).numpy()
    want = _oracle(parts, MOMENT_DESC)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[4:], want[4:].astype(np.float32))
    assert got[0, -1] == 0 and got[3, -1] == 0
    assert got[4, -1] == np.inf and got[5, -1] == -np.inf
    # the combined moments equal one pass over all the shards' values
    # (Chan): var = M2 / (n - 1) within the stated bound


def test_mesh_combine_plain_m2_is_chans_over_the_union():
    """Shards' centred moments of known values combine to the centred
    moment of their union."""
    rng = np.random.default_rng(3)
    d, w = 4, 5
    values = [[rng.normal(1e3, 1.0, rng.integers(0, 40)).astype(np.float32) for _ in range(w)]
              for _ in range(d)]
    parts = np.zeros((d, 3, w), np.float32)
    for k in range(d):
        for j, x in enumerate(values[k][:w]):
            parts[k, 0, j] = len(x)
            parts[k, 1, j] = x.sum(dtype=np.float32)
            parts[k, 2, j] = ((x - x.mean()) ** 2).sum() if len(x) else 0.0
    got = MC.mesh_combine(torch.from_numpy(parts), [(MC.SUM, 0, 0), (MC.SUM, 0, 0),
                                                    (MC.M2, 0, 1)]).numpy()
    for j in range(w):
        allx = np.concatenate([values[k][j] for k in range(d)]).astype(np.float64)
        want = ((allx - allx.mean()) ** 2).sum() if len(allx) else 0.0
        assert got[2, j] == pytest.approx(want, rel=1e-4, abs=1e-3)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("op", [MC.MIN, MC.MAX])
def test_mesh_combine_plain_nan_and_inf(d, op):
    """NaN in any shard makes the result NaN (canonical bits); +-inf and
    +-3.4e38 are values; -0.0 orders below +0.0, as kernel B's keys."""
    rng = np.random.default_rng(d)
    pool = np.array([np.inf, -np.inf, 3.4e38, -3.4e38, 0.0, -0.0, 1.5, -2.5], np.float32)
    parts = rng.choice(pool, (d, 1, 64)).astype(np.float32)
    if d > 1:
        parts[d - 1, 0, :8] = np.nan
    got = MC.mesh_combine(torch.from_numpy(parts), [(op, 0, 0)]).numpy()[0]
    nan = np.isnan(parts[:, 0]).any(axis=0)
    assert np.array_equal(np.isnan(got), nan)
    assert (got[nan].view(np.int32) == MC.CANONICAL_NAN).all()
    key = parts[:, 0].view(np.int32)
    key = np.where(key >= 0, key, key ^ 0x7FFFFFFF)
    pick = (np.argmin if op == MC.MIN else np.argmax)(key, axis=0)
    want = parts[pick, 0, np.arange(64)]
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_combine_plain_flat_state(d):
    """The flat distinct presence (MAX), HLL registers (MAX) and histogram
    (SUM) rows: exact."""
    rng = np.random.default_rng(11 + d)
    g, cap, nb = 16, 64, 40
    presence = (rng.random((d, 1, g * cap)) < 0.2).astype(np.float32)
    ranks = rng.integers(0, 20, (d, 1, g * cap)).astype(np.float32)
    hist = rng.integers(0, 500, (d, 1, g * nb)).astype(np.float32)
    for parts, op in ((presence, MC.MAX), (ranks, MC.MAX), (hist, MC.SUM)):
        got = MC.mesh_combine(torch.from_numpy(parts), [(op, 0, 0)]).numpy()
        np.testing.assert_array_equal(got, _oracle(parts, [(op, 0, 0)]).astype(np.float32))


def test_mesh_combine_checks_its_inputs():
    parts = torch.zeros((2, 3, 4))
    with pytest.raises(MC.KernelError):
        MC.mesh_combine(parts, [(MC.SUM, 0, 0)] * 2)
    with pytest.raises(MC.KernelError):
        MC.mesh_combine(parts, [(MC.M2, 5, 0)] * 3)
    with pytest.raises(MC.KernelError):
        MC.mesh_combine(parts.double(), [(MC.SUM, 0, 0)] * 3)
    assert MC.bound_ms(4, 10, 2**20) == pytest.approx(5 * 10 * 2**20 * 4 / 3.35e12 * 1e3)


# ------------------------------------------------------ K3a's KEY_WINDOW


def test_key_window_masks_and_shifts_ids():
    """KEY_WINDOW after the keys: rows outside [lo, lo + n) leave the
    verdict, the rest shift into the window; `window_at` re-points it."""
    rng = np.random.default_rng(4)
    n = 2048
    codes = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
    prog = F.Program()
    prog.const(True)
    prog.key_code(prog.slot("k", None), 16, 1)
    prog.key_window(0, 4)
    words = prog.pack()
    for lo in (0, 4, 12):
        w = torch.from_numpy(F.window_at(words, lo))
        mask, ids = F.mask_ids(w, [(codes, None)], n)
        inside = (codes >= lo) & (codes < lo + 4)
        assert torch.equal(mask, inside)
        assert torch.equal(ids[inside], (codes - lo)[inside].to(torch.int32))
        assert int(ids.min()) >= 0 and int(ids.max()) <= 3
    plain = F.Program()
    plain.const(True)
    with pytest.raises(F.KernelError):
        F.window_at(plain.pack(), 0)


# ------------------------------------------------------------- (d) resolve_mesh


@pytest.mark.parametrize("shape,count,want,warns", [
    ("", 1, None, False),
    ("", 8, {"data": 8}, False),
    ("", 6, {"data": 4}, False),
    ("off", 8, None, False),
    ("data:4", 8, {"data": 4}, False),
    ("4", 8, {"data": 4}, False),
    ("3", 8, {"data": 2}, False),
    ("16", 8, {"data": 8}, False),
    ("4x2", 8, {"data": 4, "groups": 2}, False),
    ("3x2", 8, {"data": 2, "groups": 2}, True),
    ("4x1", 8, {"data": 4}, False),
    ("4x4", 8, None, True),
    ("4xa", 8, None, True),
    ("x", 8, None, True),
])
def test_resolve_mesh_shapes(monkeypatch, caplog, shape, count, want, warns):
    """P_TPU_MESH's shapes, the power-of-two clamp and its warning, too few
    devices and a malformed shape (each a warning and no mesh), and the
    auto mesh over every visible card, with `count` cards visible."""
    monkeypatch.setattr(X, "_MESH_CACHE", {})
    monkeypatch.setattr(X.torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(X, "make_mesh", lambda n: PM.make_mesh(n, devices=["cpu"] * n))
    monkeypatch.setattr(X, "make_mesh_2d",
                        lambda a, b: PM.make_mesh_2d(a, b, devices=["cpu"] * (a * b)))
    opts = Options()
    opts.mesh_shape = shape
    with caplog.at_level(logging.WARNING, logger=X.logger.name):
        mesh = X.resolve_mesh(opts, "cuda")
    assert (mesh.shape if mesh is not None else None) == want
    assert bool([r for r in caplog.records if r.levelno >= logging.WARNING]) == warns
    assert X.resolve_mesh(opts, "cuda") is mesh  # cached
    # a CPU executor sees one device: only a pinned mesh gives it one
    assert X.resolve_mesh(opts, "cpu") is None


def test_resolve_mesh_raises_on_a_bad_count(monkeypatch):
    """Unlike the JAX package, an error while resolving raises."""
    monkeypatch.setattr(X, "_MESH_CACHE", {})
    opts = Options()
    opts.mesh_shape = "data:two"
    with pytest.raises(ValueError):
        X.resolve_mesh(opts, "cuda")


def test_pinned_mesh_wins_and_pins_do_not_nest(monkeypatch):
    opts = Options()
    opts.mesh_shape = "off"
    mesh = PM.make_mesh(2, devices=["cpu"] * 2)
    with PM.pin_mesh(mesh):
        assert X.resolve_mesh(opts, "cpu") is mesh
        ex = X.GpuQueryExecutor(port_plan(port_parse("SELECT count(*) FROM t")), device="cpu")
        assert ex.mesh is mesh and X._mesh_group_shards(ex.mesh) == 1
        with pytest.raises(RuntimeError):
            with PM.pin_mesh(mesh):
                pass
    assert X.resolve_mesh(opts, "cpu") is None
    assert X._mesh_group_shards(PM.make_mesh_2d(2, 4, devices=["cpu"] * 8)) == 4


# ------------------------------------------------------ (c) the GPU executor


def make_table(n=20000, seed=0) -> pa.Table:
    """test_mesh_engine.py's table."""
    rng = np.random.default_rng(seed)
    ts = [BASE + timedelta(seconds=int(i)) for i in rng.integers(0, 3600, n)]
    return pa.table({
        "p_timestamp": pa.array(ts, pa.timestamp("ms")),
        "status": pa.array(rng.choice(["200", "404", "500"], n).tolist()),
        "bytes": pa.array(rng.random(n) * 1000),
        "host": pa.array(rng.choice(["a", "b", "c", "d"], n).tolist()),
    })


@pytest.fixture(scope="module")
def tables() -> list[pa.Table]:
    return [make_table(6000, seed=s) for s in range(3)]


def _blocks(tables):
    return [t.replace_schema_metadata({X.SOURCE_ID_META: f"mesh{i}".encode()})
            for i, t in enumerate(tables)]


def port_gpu(sql: str, tables, mesh=None) -> tuple[list[dict], dict]:
    """The port's GPU engine on the CPU, each table a block of its own,
    under `mesh` (pinned) or on one device."""
    get_hotset().clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P_TPU_ENC_CACHE", "0")
        if mesh is None:
            ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
            assert ex.mesh is None  # a CPU executor sees one device
            return ex.execute(iter(_blocks(tables))).to_pylist(), ex.route_stats
        with PM.pin_mesh(mesh):
            ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
            assert ex.mesh is mesh
            return ex.execute(iter(_blocks(tables))).to_pylist(), ex.route_stats


def port_cpu(sql: str, tables) -> list[dict]:
    return PortCpuExecutor(port_plan(port_parse(sql))).execute(iter(tables)).to_pylist()


_JAX_ANSWERS: dict[str, list[dict]] = {}


def jax_tpu_mesh(sql: str, tables, tmp_path) -> list[dict]:
    """The JAX "tpu" engine on conftest's 8-device CPU mesh (cached per
    query: the port's meshes are all held against it), its link profile
    rooted in `tmp_path`."""
    if sql not in _JAX_ANSWERS:
        opts = JaxOptions()
        opts.local_staging_path = tmp_path
        opts.mesh_shape = "8"
        ex = ET.TpuQueryExecutor(jax_plan(jax_parse(sql)), opts)
        assert ex.mesh is not None and ex.mesh.size == 8
        _JAX_ANSWERS[sql] = ex.execute(iter(tables)).to_pylist()
    return _JAX_ANSWERS[sql]


def assert_rows(ref: list[dict], got: list[dict], sql: str, ordered: bool = False,
                pct: tuple = ()) -> None:
    def key(r):
        return tuple(str(r[k]) for k in sorted(r) if not isinstance(r[k], float))

    if not ordered:
        ref, got = sorted(ref, key=key), sorted(got, key=key)
    assert len(ref) == len(got), (sql, len(ref), len(got))
    for a, b in zip(ref, got):
        assert set(a) == set(b), sql
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, float) and isinstance(y, float):
                rel = PCT_REL if k in pct else TOL["rel"]
                assert y == pytest.approx(x, rel=rel, abs=TOL["abs"]), (sql, k, x, y)
            else:
                assert x == y, (sql, k, x, y)


MESH_SQL = [
    # test_mesh_engine.py's list
    "SELECT status, count(*) c, sum(bytes) s, min(bytes) mn, max(bytes) mx "
    "FROM t WHERE host != 'd' GROUP BY status",
    "SELECT date_bin(interval '5m', p_timestamp) b, host, count(*) c, avg(bytes) a "
    "FROM t WHERE status = '500' GROUP BY b, host",
    "SELECT count(*) c FROM t WHERE bytes > 500 AND host IN ('a', 'b')",
    "SELECT host, count(*) c FROM t WHERE status LIKE '4%' GROUP BY host",
    "SELECT count(*) c, sum(bytes) s FROM t",
    # and the statistics of the dense fold
    "SELECT host, status, count(*) c, stddev(bytes) sd, var(bytes) vb FROM t GROUP BY host, status",
    "SELECT status, count(distinct host) d, approx_distinct(host) ad, "
    "approx_percentile_cont(bytes, 0.9) p90 FROM t GROUP BY status",
]
PCT_COLS = ("p90",)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("sql", MESH_SQL)
def test_mesh_groupby_parity(mesh_name, sql, tables, tmp_path):
    """Each query under each mesh equals the port's one-device answer, its
    CPU engine's and the JAX engine's on its 8-device mesh; every block
    folds row-sharded, none on the host."""
    mesh = MESHES[mesh_name]()
    before = X.MESH_PROGRAMS_BUILT[0], X.GROUP_SHARDED_PROGRAMS_BUILT[0]
    got, routes = port_gpu(sql, tables, mesh)
    one, _ = port_gpu(sql, tables)
    for ref in (one, port_cpu(sql, tables), jax_tpu_mesh(sql, tables, tmp_path)):
        assert_rows(ref, got, sql, pct=PCT_COLS)
    assert routes["device_mesh"] == 3 and routes["cpu_fallback"] == 0, routes
    assert routes["mesh_unsharded"] == 0, routes
    assert X.MESH_PROGRAMS_BUILT[0] == before[0] + 3
    if mesh.n_groups > 1 and "GROUP BY" in sql:
        assert X.GROUP_SHARDED_PROGRAMS_BUILT[0] == before[1] + 3
    else:
        assert X.GROUP_SHARDED_PROGRAMS_BUILT[0] == before[1]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_topk_after_the_window_gather(monkeypatch, mesh_name, tables):
    """ORDER BY <aggregate> LIMIT: K8's plain version picks over every
    group, the windows of a groups-sharded accumulator gathered first."""
    monkeypatch.setattr(X.GpuQueryExecutor, "TOPK_MIN_GROUPS", 1)
    calls = []
    real = X.topk_cuda.topk_groups

    def spy(acc, *args, **kw):
        calls.append(tuple(acc.shape))
        return real(acc, *args, **kw)

    monkeypatch.setattr(X.topk_cuda, "topk_groups", spy)
    sql = ("SELECT date_bin(interval '5m', p_timestamp) b, host, sum(bytes) s, count(*) c "
           "FROM t GROUP BY b, host ORDER BY s DESC LIMIT 7")
    got, routes = port_gpu(sql, tables, MESHES[mesh_name]())
    assert calls and routes["device_mesh"] == 3, (calls, routes)
    one, _ = port_gpu(sql, tables)
    assert_rows(one, got, sql, ordered=True)
    assert_rows(port_cpu(sql, tables), got, sql, ordered=True)


@pytest.mark.parametrize("mesh_name", ["8", "4x2", "2x2 cards"])
def test_mesh_select(mesh_name, tables):
    """A select's WHERE mask runs on each data shard; the shard masks make
    one host mask."""
    sql = "SELECT host, bytes FROM t WHERE bytes > 900 AND status != '404'"
    got, routes = port_gpu(sql, tables, MESHES[mesh_name]())
    assert routes["device_mesh"] == 3 and routes["cpu_fallback"] == 0, routes
    key = lambda r: (r["host"], r["bytes"])  # noqa: E731
    assert sorted(got, key=key) == sorted(port_cpu(sql, tables), key=key)


@pytest.fixture(scope="module")
def highcard_tables() -> list[pa.Table]:
    """tests/test_highcard.py's inputs: three blocks, ~120k user ids."""
    rng = np.random.default_rng(11)
    out = []
    for b in range(3):
        n = 60_000
        uid = rng.integers(b * 30_000, b * 30_000 + 60_000, n)
        out.append(pa.table({"user": pa.array([f"u{int(x)}" for x in uid]),
                             "bytes": pa.array(rng.random(n) * 100.0),
                             "lat": pa.array(rng.random(n) * 10.0)}))
    return out


@pytest.mark.parametrize("mesh_name", ["8", "2x2 cards"])
def test_mesh_local_mode(monkeypatch, mesh_name, highcard_tables):
    """Past the dense budget each block folds block-local: each data shard
    into a fresh partial, K10's plain version combines (sum, Chan's M2,
    min, max), one readback a block."""
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 14)
    sql = ("SELECT user, count(*) c, sum(bytes) s, min(lat) mn, max(lat) mx, "
           "stddev(lat) sd FROM t GROUP BY user")
    got, routes = port_gpu(sql, highcard_tables, MESHES[mesh_name]())
    assert routes["device_local"] == routes["device_mesh"] == 3, routes
    assert routes["cpu_fallback"] == 0, routes
    one, _ = port_gpu(sql, highcard_tables)
    assert_rows(one, got, sql)
    assert_rows(port_cpu(sql, highcard_tables), got, sql)


@pytest.mark.parametrize("mesh_name", ["4x2", "4 cards"])
def test_mesh_pair_mode(monkeypatch, mesh_name):
    """Pair mode: the block's `__pairkey` codes shard with its rows."""
    rng = np.random.default_rng(21)
    tables = []
    for _ in range(2):
        n = 30_000
        tables.append(pa.table({
            "a": pa.array([f"a{int(x)}" for x in rng.integers(0, 500, n)]),
            "b": pa.array([f"b{int(x)}" if x % 11 else None for x in rng.integers(0, 500, n)]),
            "v": pa.array(rng.random(n)),
        }))
    monkeypatch.setattr(X, "DENSE_G_MAX", 1 << 12)
    monkeypatch.setattr(X, "LOCAL_G_MAX", 1 << 16)
    sql = ("SELECT a, b, count(*) c, sum(v) s, min(v) mn, stddev(v) sd FROM t GROUP BY a, b "
           "ORDER BY s DESC LIMIT 50")
    got, routes = port_gpu(sql, tables, MESHES[mesh_name]())
    assert routes["device_local"] == routes["device_mesh"] == 2, routes
    one, _ = port_gpu(sql, tables)
    assert_rows(one, got, sql, ordered=True)
    assert_rows(port_cpu(sql, tables), got, sql, ordered=True)


# ------------------------------------------- (e) blocks that do not divide


def test_a_block_that_does_not_divide_stays_on_one_device(tables):
    """A data axis of 3 does not divide 8,192-row blocks: each folds on the
    executor's device, as in the JAX package, counted as unsharded."""
    sql = MESH_SQL[0]
    got, routes = port_gpu(sql, tables, PM.make_mesh(3, devices=["cpu"] * 3))
    assert (routes["device_mesh"], routes["mesh_unsharded"]) == (0, 3), routes
    assert_rows(port_cpu(sql, tables), got, sql)


def test_unsharded_block_under_groups_windows_on_several_cards(tables):
    """On a 3 x 2 mesh over six cards the accumulator is two windows on two
    cards; a block that cannot split gathers them, folds and scatters."""
    mesh = PM.make_mesh_2d(3, 2, devices=[f"cpu:{i}" for i in range(6)])
    sql = "SELECT host, count(*) c, sum(bytes) s, count(distinct status) d FROM t GROUP BY host"
    got, routes = port_gpu(sql, tables, mesh)
    assert routes["mesh_unsharded"] == 3, routes
    assert_rows(port_cpu(sql, tables), got, sql)


def test_hot_entries_follow_the_layout(tables):
    """A block resident from a one-device query is a hit for a virtual
    mesh (its shards are views), a miss for a mesh over several cards,
    whose sharded entry then misses for one device again."""
    sql = MESH_SQL[3]
    get_hotset().clear()
    blocks = _blocks(tables)

    def run(mesh=None):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("P_TPU_ENC_CACHE", "0")
            if mesh is None:
                ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
                return ex.execute(iter(blocks)).to_pylist(), ex.route_stats
            with PM.pin_mesh(mesh):
                ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
                return ex.execute(iter(blocks)).to_pylist(), ex.route_stats

    want, r = run()
    assert r["device_cold"] == 3
    got, r = run(MESHES["8"]())
    assert r["device_warm"] == 3 and r["device_mesh"] == 3, r
    assert_rows(want, got, sql)
    cards = MESHES["4 cards"]()
    got, r = run(cards)
    assert r["device_cold"] == 3, r
    assert_rows(want, got, sql)
    got, r = run(cards)
    assert r["device_warm"] == 3, r
    entries = [get_hotset().get(k, touch=False) for k in list(get_hotset()._entries)]
    assert len(entries) == 3
    for e in entries:
        assert e.shards is not None and e.placement == cards.placement and not e.dev
        # one shard a card here: nbytes is the shards' bytes, each 16-byte aligned
        shard_bytes = [t.numel() * t.element_size() for t in e.tensors()]
        assert sum(shard_bytes) <= e.nbytes < sum(shard_bytes) + 16 * len(shard_bytes)
    got, r = run()
    assert r["device_cold"] == 3, r
    get_hotset().clear()


def test_session_queries_run_under_the_mesh(tmp_path, monkeypatch):
    """Through `QuerySession` (what the server's query handler calls) a
    lake query folds every block over the pinned mesh, and answers as on
    one device and on the CPU engine."""
    from parseable_tpu_torch.config import StorageOptions
    from parseable_tpu_torch.core import Parseable
    from parseable_tpu_torch.query.session import QuerySession

    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    opts = Options()
    opts.local_staging_path = tmp_path / "staging"
    opts.query_result_cache_bytes = 0
    p = Parseable(opts, StorageOptions(root=tmp_path / "data"))
    try:
        stream = p.create_stream_if_not_exists("meshweb")
        for minute in range(3):
            t = make_table(4000, seed=minute)
            t = t.set_column(0, "p_timestamp", pa.array(
                [BASE + timedelta(minutes=minute, seconds=i % 60) for i in range(t.num_rows)],
                pa.timestamp("ms")))
            stream.write_parquet(t, BASE + timedelta(minutes=minute))
        p.sync_all_streams()
        sql = "SELECT host, count(*) c, sum(bytes) s, stddev(bytes) sd FROM meshweb GROUP BY host"
        get_hotset().clear()
        one = QuerySession(p, engine="gpu", device="cpu").query(sql, "2024-05-01T09:00:00Z",
                                                              "2024-05-01T11:00:00Z")
        with PM.pin_mesh(MESHES["2x2 cards"]()):
            got = QuerySession(p, engine="gpu", device="cpu").query(sql, "2024-05-01T09:00:00Z",
                                                                  "2024-05-01T11:00:00Z")
        cpu = QuerySession(p, engine="cpu").query(sql, "2024-05-01T09:00:00Z",
                                                  "2024-05-01T11:00:00Z")
        r = got.stats["device_routes"]
        assert r["device_mesh"] == 3 and r["cpu_fallback"] == 0, r
        assert one.stats["device_routes"]["device_mesh"] == 0
        for ref in (one, cpu):
            assert_rows(ref.table.to_pylist(), got.table.to_pylist(), sql)
    finally:
        p.shutdown()
        get_hotset().clear()
