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
