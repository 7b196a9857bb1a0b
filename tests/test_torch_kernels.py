"""The port's group-by kernels against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions
(`parseable_tpu/ops/kernels.py`, and the Pallas kernel in interpret mode as
tests/test_parallel.py runs it) and through the port's
(`parseable_tpu_torch/ops/`), whose wrappers compute their kernels' plain
versions on CPU tensors. Tolerances, after tests/test_engine_fuzz.py:

- counts (row count, per-aggregate counts): exact — f32 adds of 0/1 are
  exact below 2^24 in any order;
- sums: rel 2e-4 — f32 adds in another order than JAX's dot or scatter;
- min/max: exact — no arithmetic, only order; this includes the +-3.4e38
  sentinel of a group whose rows are all masked and the +-inf identity of a
  group no row reaches.

The CUDA kernels themselves run only on a card; tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parseable_tpu.ops.kernels as JK
from parseable_tpu.ops.pallas_groupby import additive_groupby_pallas
from parseable_tpu_torch.ops import groupby_cuda as G
from parseable_tpu_torch.ops import kernels as TK

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
        g=g, n_sum=n_sum, n_min=n_min, n_max=n_max,
    )


def _both(b, ids_dtype=np.int32):
    ids = b["ids"].astype(ids_dtype)
    ref = JK.fused_groupby_block(
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(b["mask"]), jnp.asarray(b["sums"]),
        jnp.asarray(b["mins"]), jnp.asarray(b["maxs"]), jnp.asarray(b["valid"]),
        b["g"], b["n_sum"], b["n_min"], b["n_max"],
    )
    got = TK.fused_groupby_block(
        torch.from_numpy(ids), torch.from_numpy(b["mask"]), torch.from_numpy(b["sums"]),
        torch.from_numpy(b["mins"]), torch.from_numpy(b["maxs"]), torch.from_numpy(b["valid"]),
        b["g"], b["n_sum"], b["n_min"], b["n_max"],
    )
    return [np.asarray(r) for r in ref], [t.numpy() for t in got]


def _assert_outputs(ref, got):
    for name, (r, t) in zip(("count", "per_agg_count", "sums", "mins", "maxs"), zip(ref, got)):
        assert r.shape == t.shape, (name, r.shape, t.shape)
        assert t.dtype == np.float32, name
    np.testing.assert_array_equal(got[0], ref[0])  # counts exact
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], **SUM_TOL)
    np.testing.assert_array_equal(got[3], ref[3])  # min/max exact
    np.testing.assert_array_equal(got[4], ref[4])


# (label, n, g, n_sum, n_min, n_max, n_cnt, id_span, dead_group)
CASES = [
    ("onehot-dot", 4096, 128, 2, 1, 1, 1, None, None),
    ("g-over-pallas-cap", 4096, 1024, 1, 1, 1, 0, None, None),  # JAX: XLA dot, G > 512
    ("g-over-onehot-cap", 3000, 9000, 2, 1, 2, 0, None, None),  # JAX: segment_sum
    ("onehot-elems-cap", 5000, 2048, 1, 0, 1, 1, None, None),  # N*G > 2^22: segment_sum
    ("empty-groups", 4096, 256, 1, 2, 2, 0, 100, None),  # groups >= 100: +-inf
    ("all-masked-group", 4096, 64, 1, 1, 1, 0, None, 3),  # group 3: +-3.4e38
    ("ragged-n", 3001, 100, 1, 1, 1, 0, None, None),  # N not a multiple of 2048
    ("no-minmax", 2048, 32, 3, 0, 0, 2, None, None),
    ("count-only", 1000, 16, 0, 0, 0, 0, None, None),
    # kernel A's "global" regime (a group-major record on the card): R = 8, 3
    ("global-regime-r8", 16384, 65536, 2, 1, 1, 1, None, None),
    ("global-regime-r3", 16384, 1 << 17, 1, 0, 0, 0, 9000, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_groupby_block_matches_jax(case):
    _label, n, g, n_sum, n_min, n_max, n_cnt, span, dead = case
    b = _block(7, n, g, n_sum, n_min, n_max, n_cnt, span, dead)
    ref, got = _both(b)
    _assert_outputs(ref, got)
    if span is not None:
        assert np.isposinf(got[3][:, span:]).all() and np.isneginf(got[4][:, span:]).all()
    if dead is not None:
        assert (got[3][:, dead] == np.float32(3.4e38)).all()
        assert (got[4][:, dead] == -np.float32(3.4e38)).all()


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_narrow_codes(dtype):
    """Codes ship as int8/int16 (ops/device.py _code_dtype); torch indexes
    only with int32/int64 (and reads uint8 as a mask), so the port widens
    them. Both the LUT gather and the group ids must match JAX, which gets
    the codes widened to int32 as its executor's _as_index widens them (a
    128-entry LUT overflows an int8 index in JAX)."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 100, 4096).astype(dtype)
    lut = rng.random(128) < 0.5
    ref = np.asarray(JK.lut_mask(jnp.asarray(codes.astype(np.int32)), jnp.asarray(lut)))
    got = TK.lut_mask(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, ref)
    b = _block(5, 4096, 128, 1, 1, 1, 0)
    b["ids"] = codes.astype(np.int32)
    ref, got = _both(b, ids_dtype=dtype)
    _assert_outputs(ref, got)


def test_plain_additive_matches_pallas_interpret():
    """Kernel A's plain version against the Pallas kernel, in interpret mode
    as tests/test_parallel.py:101 runs it (N = 4096, G = 128, R = 5)."""
    rng = np.random.default_rng(0)
    n, g, r = 4096, 128, 5
    ids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    rows = np.concatenate(
        [
            mask[None].astype(np.float32),
            (rng.random((2, n)) < 0.8).astype(np.float32) * mask,
            (rng.random((r - 3, n)) * 1000).astype(np.float32) * mask,
        ]
    )
    ref = np.asarray(
        additive_groupby_pallas(jnp.asarray(ids), jnp.asarray(rows), g, interpret=True)
    )
    got = G.additive_groupby(torch.from_numpy(ids), torch.from_numpy(rows), g).numpy()
    np.testing.assert_array_equal(got[:3], ref[:3])
    np.testing.assert_allclose(got[3:], ref[3:], **SUM_TOL)


def test_plain_versions_drop_out_of_range_ids():
    """Ids outside [0, G) contribute nothing, as the one-hot product and
    JAX's segment ops drop them; the CUDA kernels skip them the same way."""
    ids = torch.tensor([0, 1, 5, -1, 1], dtype=torch.int32)
    rows = torch.ones((1, 5))
    np.testing.assert_array_equal(G.additive_groupby(ids, rows, 2).numpy(), [[1.0, 2.0]])
    vals = torch.tensor([[3.0, 4.0, -9.0, -9.0, 2.0], [3.0, 4.0, 99.0, 99.0, 2.0]])
    valid = torch.ones((2, 5), dtype=torch.bool)
    mask = torch.ones(5, dtype=torch.bool)
    mn, mx = G.minmax_groupby(ids, vals, valid, mask, 3, 1)
    np.testing.assert_array_equal(mn.numpy(), [[3.0, 2.0, np.inf]])
    np.testing.assert_array_equal(mx.numpy(), [[3.0, 4.0, -np.inf]])


def test_wrappers_compute_plain_on_cpu_and_check_inputs():
    before = dict(G.LAUNCHES)
    ids = torch.zeros(8, dtype=torch.int32)
    G.additive_groupby(ids, torch.ones((2, 8)), 4)
    G.minmax_groupby(ids, torch.ones((2, 8)), torch.ones((2, 8), dtype=torch.bool),
                     torch.ones(8, dtype=torch.bool), 4, 1)
    assert G.LAUNCHES == before  # CPU tensors never launch a kernel
    with pytest.raises(G.KernelError):
        G.additive_groupby(ids.to(torch.int64), torch.ones((2, 8)), 4)
    with pytest.raises(G.KernelError):
        G.additive_groupby(ids, torch.ones((2, 7)), 4)
    with pytest.raises(G.KernelError):
        G.minmax_groupby(ids, torch.ones((2, 8)), torch.ones((1, 8), dtype=torch.bool),
                         torch.ones(8, dtype=torch.bool), 4, 1)


# ------------------------------------------------- kernel A's tensor regime


def _split_inputs() -> np.ndarray:
    """Seeded values over the lake's ranges and beyond, plus 0, -0,
    +-F32_MAX, the smallest normal and subnormals."""
    rng = np.random.default_rng(17)
    f32 = np.finfo(np.float32)
    return np.concatenate(
        [
            (rng.random(4096) * 50_000).astype(np.float32),  # bytes
            (rng.random(4096) * 500).astype(np.float32),  # latency_ms
            (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32),
            rng.integers(0, 2**31, 4096).astype(np.uint32).view(np.float32),  # any bits
            np.array([0.0, -0.0, f32.max, -f32.max, 3.4e38, -3.4e38, f32.tiny, 1.0, -1.0],
                     np.float32),
            np.array([1e-45, -1e-45, 1e-40, 2.0**-130, 2.0**-110], np.float32),  # subnormals
        ]
    )


def test_bf16_split_reconstructs_every_f32():
    """hi + mid + lo == x exactly (f32 arithmetic), in either order; every
    piece is exact in bf16 for |x| >= 2^-110, and below that what lo loses is
    under 2^-133; a rounding split would overflow at 3.4e38."""
    x = torch.from_numpy(_split_inputs())
    x = x[torch.isfinite(x)]
    hi, mid, lo = G.bf16_split(x)
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(hi + (mid + lo), x)
    normal = x.abs() >= 2.0**-110
    for piece in (hi, mid, lo):
        assert torch.isfinite(piece).all()
        as_bf16 = piece.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(as_bf16[normal], piece[normal])
        assert ((as_bf16 - piece).abs() < 2.0**-133).all()
    assert torch.isinf(torch.tensor([3.4e38]).to(torch.bfloat16)).all()


def _pallas_case(seed: int, n: int, g: int, r: int, span: int | None = None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, span or g, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    n_valid = (r - 1) // 2
    rows = np.concatenate(
        [
            mask[None].astype(np.float32),
            (rng.random((n_valid, n)) < 0.8).astype(np.float32) * mask,
            (rng.random((r - 1 - n_valid, n)) * 50_000).astype(np.float32) * mask,
        ]
    )
    return ids, rows, 1 + n_valid


# (n, g, r, id span): the main path's three tensor shapes, G = 128, and skewed ids
TENSOR_CASES = [(4096, 8, 3, None), (4096, 64, 3, None), (6144, 64, 5, None),
                (2048, 128, 5, None), (4096, 64, 5, 5)]


@pytest.mark.parametrize("case", TENSOR_CASES, ids=[f"n{c[0]}-g{c[1]}-r{c[2]}" for c in TENSOR_CASES])
def test_tensor_model_matches_pallas_interpret(case):
    """The tensor regime's formula (bf16 one-hot, rows split into three bf16
    pieces, f32 accumulate) against the Pallas kernel in interpret mode:
    counts exact, sums rel 2e-4."""
    n, g, r, span = case
    ids, rows, counts = _pallas_case(n + g, n, g, r, span)
    ref = np.asarray(
        additive_groupby_pallas(jnp.asarray(ids), jnp.asarray(rows), g, interpret=True)
    )
    got = G.additive_groupby_tensor_model(torch.from_numpy(ids), torch.from_numpy(rows), g).numpy()
    np.testing.assert_array_equal(got[:counts], ref[:counts])
    np.testing.assert_allclose(got[counts:], ref[counts:], **SUM_TOL)


def test_tensor_model_confines_nonfinite_values():
    """NaN and +-inf enter the product as 0 and their own group directly, as
    index_add_ confines them; a plain one-hot product would spread a NaN to
    every group of its row."""
    ids, rows, counts = _pallas_case(3, 4096, 64, 5)
    ids[[10, 11, 12]] = [0, 1, 2]
    rows[-1, [10, 11, 12]] = [np.nan, np.inf, -np.inf]
    t_ids, t_rows = torch.from_numpy(ids), torch.from_numpy(rows)
    got = G.additive_groupby_tensor_model(t_ids, t_rows, 64)
    ref = G.additive_groupby_plain(t_ids, t_rows, 64)
    assert torch.isnan(got[-1, 0]) and got[-1, 1] == np.inf and got[-1, 2] == -np.inf
    assert int(torch.isnan(got).sum()) == 1
    torch.testing.assert_close(got, ref, equal_nan=True, **SUM_TOL)


# (R, G, regime): tensor where R <= 8, G <= 128, ceil16(G) * 24 <= 590 (R + 1)
# and ceil16(G) / 16 < R; shared where R * G * 4 <= 200 KB; else global
REGIME_RULE = [
    (3, 8, "tensor"), (3, 64, "shared"), (5, 64, "tensor"),  # regex_filter, minmax, groupby
    (3, 8192, "shared"),  # topk_multicol
    (3, 32, "tensor"), (3, 48, "shared"), (5, 80, "shared"), (5, 64, "tensor"),
    (5, 128, "shared"), (8, 112, "tensor"), (8, 128, "shared"), (1, 16, "shared"),
    (2, 16, "tensor"), (9, 8, "shared"), (5, 2048, "shared"), (5, 10240, "shared"),
    (5, 10241, "global"), (5, 65536, "global"),
]


@pytest.mark.parametrize("r,g,regime", REGIME_RULE, ids=[f"R{a}-G{b}" for a, b, _ in REGIME_RULE])
def test_additive_regime_rule(r, g, regime):
    assert G.additive_regime(r, g) == regime


# (R, floats of a group's record in kernel A's "global" regime): whole
# 16-byte vectors, one vector reduction per four value rows
RECORD_WIDTHS = [(1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 12)]


@pytest.mark.parametrize("r,width", RECORD_WIDTHS, ids=[f"R{a}" for a, _ in RECORD_WIDTHS])
def test_global_regime_record_width(r, width):
    assert G.record_width(r) == width


# (K, G, decode): kernel B's last CTA decodes up to 2048 key entries itself,
# a decode launch of its own takes more
DECODE_RULE = [(2, 64, "kernel"), (3, 64, "kernel"), (2, 1024, "kernel"), (2, 1025, "launch"),
               (2, 4096, "launch"), (2, 65536, "launch"), (10, 204, "kernel"), (10, 205, "launch")]


@pytest.mark.parametrize("k,g,decode", DECODE_RULE, ids=[f"K{a}-G{b}" for a, b, _ in DECODE_RULE])
def test_minmax_decode_rule(k, g, decode):
    assert G.minmax_decode(k, g) == decode
