"""Hand-written CUDA kernels of the dense fold's statistics: build, bind,
launch, and plain versions.

Three kernels (sources and design notes in `csrc/stats.cu`), each the
counterpart of one XLA program of the JAX dense fold
(`parseable_tpu/query/executor_tpu.py`):

- `distinct_fold(acc, group_ids, codes, mask, cap, lut)` — K5, count(distinct)
  presence bitmaps and approx_distinct HLL registers, folded by max into a
  flat [G * cap] f32 accumulator (:2931-2953);
- `pct_histogram(acc, vals, group_ids, mask)` — K6, per-group log2
  histograms in the `query/sketch.py` DEVICE_NB layout, added into a flat
  [G * DEVICE_NB] f32 accumulator (:2954-2981);
- `centered_m2(group_ids, vals, valid, mask, mean)` — K7, per-group centred
  second moments of one block for stddev/var (`_block_m2` :889).

Each runs in a regime chosen per shape by its `*_regime` rule or forced
with `regime=`: "shared" (a per-CTA private accumulator in shared memory),
"global" (atomics straight into the accumulator) and "compact" (each CTA
streams a contiguous chunk: K5 and K6 fold it into a shared copy of only
the groups its rows reach, or with global atomics where they do not fit;
K7 sums each thread's rows into a private column of [Q, G] cells).
Beside each wrapper is its plain PyTorch version (`*_plain`, functional: it
returns a new tensor). A wrapper given CPU tensors computes
the plain version; given CUDA tensors it launches its kernel or raises
`KernelError`. `LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from parseable_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    KernelError,
    check,
    check_ids,
    on_cuda,
    require,
)
from parseable_tpu_torch.ops.groupby_cuda import SMEM_BUDGET
from parseable_tpu_torch.query.sketch import BINS, DEVICE_NB, LOG_HI, LOG_LO, _SCALE

__all__ = ["KernelError", "LAUNCHES", "centered_m2", "distinct_fold", "pct_histogram"]

REGIMES = {"shared": 0, "global": 1, "compact": 2}
# the JAX fold's f32 constants of the percentile slot (executor_tpu.py:2962-2970)
PCT_LO = float(np.float32(LOG_LO))
PCT_HI = float(np.float32(LOG_HI - 1e-6))
PCT_SCALE = float(np.float32(_SCALE))
F32_TINY = float(np.finfo(np.float32).tiny)  # the least normal f32
_NO_LUT_V = 2**31 - 1  # without a LUT every non-negative code is a slot (clamped)
COMPACT_G_MAX = 65536  # groups the compact regime's bitmap covers (csrc kBitmapG)
COMPACT_PRESENCE_WORDS = 1024  # presence words a compact CTA holds (csrc kPresenceWords)
DISTINCT_SHARED_MAX = 8192  # entries of K5's whole private copy (the earlier rule)
M2_COMPACT_CELLS = 16  # [Q, G] cells of a compact K7 thread's column (csrc kM2Cells)

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"distinct_fold": 0, "pct_histogram": 0, "centered_m2": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.distinct_fold.argtypes = [p, p, i, p, p, p, i, i, i, ll, p, i, p]
    lib.distinct_fold.restype = i
    lib.pct_histogram.argtypes = [p, p, p, i, ll, f, f, f, p, i, p]
    lib.pct_histogram.restype = i
    lib.centered_m2.argtypes = [p, p, p, p, p, i, i, ll, p, i, p]
    lib.centered_m2.restype = i


LIBRARY = CudaLibrary("stats.cu", _bind)


def _known(regime: str | None) -> None:
    require(regime is None or regime in REGIMES, f"unknown regime {regime!r}")


def _mode(regime: str, nbytes: int) -> int:
    """The C entry's mode for `regime`; raises for a "shared" accumulator of
    `nbytes` that shared memory cannot hold (a "compact" CTA decides on the
    card whether its groups fit)."""
    _known(regime)
    require(regime != "shared" or nbytes <= SMEM_BUDGET, f"{nbytes} bytes do not fit shared memory")
    return REGIMES[regime]


def _spare(acc: torch.Tensor) -> torch.Tensor:
    """acc with one spare trailing slot that rows to be dropped scatter into."""
    return torch.cat([acc, acc.new_zeros(1)])


# ---------------------------------------------------------------------- K5


def distinct_regime(num_groups: int, cap: int, hll: bool = False) -> str:
    """"compact" for HLL registers up to COMPACT_G_MAX groups, and for
    presence bits where a CTA's copy holds every group's bits (up to
    COMPACT_PRESENCE_WORDS words); past those the earlier rule: "shared" (a
    whole copy of the G * cap entries a CTA) up to 8,192 entries, else
    "global". On an H100 (PERF.md) compact beat the earlier regimes at the
    main path's shapes (presence 64 x 128, HLL 64 x 4,096); presence blocks
    whose CTAs each touch more groups than the copy holds fold faster in
    "global"; HLL blocks so spread do too, but they share the main path's
    shape."""
    if num_groups > COMPACT_G_MAX:
        return "global"
    if hll or num_groups * ((cap + 31) // 32) <= COMPACT_PRESENCE_WORDS:
        return "compact"
    return "shared" if num_groups * cap <= DISTINCT_SHARED_MAX else "global"


def distinct_fold_plain(
    acc: torch.Tensor,
    group_ids: torch.Tensor,
    codes: torch.Tensor,
    mask: torch.Tensor,
    cap: int,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """max(acc, update) over acc f32 [G * cap]: each live row maxes its value
    into slot `group_id * cap + min(slot(code), cap - 1)`. Without `lut` the
    code is the slot and the value 1; with a 1-D `lut` [V] (global dictionary
    remap) the slot is lut[code] and the value 1; with a [2, V] `lut` (HLL)
    the slot is lut[0][code] and the value lut[1][code] (rank). Rows with an
    id outside [0, G), a negative code or (with a LUT) a code >= V drop."""
    g = acc.numel() // cap
    c = codes.long()
    v = _NO_LUT_V if lut is None else lut.shape[-1]
    live = mask & (group_ids >= 0) & (group_ids < g) & (c >= 0) & (c < v)
    c = torch.where(live, c, 0)
    if lut is None:
        slot, val = c, live.float()
    elif lut.dim() == 1:
        slot, val = lut.long()[c], live.float()
    else:
        slot, val = lut[0].long()[c], lut[1][c].float() * live
    slot = torch.clamp(slot, max=cap - 1)
    live &= slot >= 0
    flat = torch.where(live, group_ids.long() * cap + slot, g * cap)
    out = _spare(acc).scatter_reduce(0, flat, torch.where(live, val, 0.0), "amax")
    return out[:-1]


def distinct_fold(
    acc: torch.Tensor,
    group_ids: torch.Tensor,
    codes: torch.Tensor,
    mask: torch.Tensor,
    cap: int,
    lut: torch.Tensor | None = None,
    *,
    regime: str | None = None,
) -> torch.Tensor:
    """K5: fold one block into acc f32 [G * cap] IN PLACE and return it.
    group_ids int32 [N], codes int8/int16/int32 [N], mask bool [N] (row
    live and value non-null), lut int32 [V] or [2, V] (see the plain
    version)."""
    require(acc.dtype == torch.float32 and acc.dim() == 1, "acc must be f32 [G * cap]")
    require(cap >= 1 and acc.numel() % cap == 0, "acc must hold G * cap entries")
    n = codes.shape[0]
    check_ids(group_ids, n)
    require(codes.dtype in (torch.int8, torch.int16, torch.int32) and codes.dim() == 1,
            "codes must be int8/int16/int32 [N]")
    require(mask.dtype == torch.bool and tuple(mask.shape) == (n,), "mask must be bool [N]")
    if lut is not None:
        require(lut.dtype == torch.int32 and lut.dim() in (1, 2) and (lut.dim() == 1 or lut.shape[0] == 2),
                "lut must be int32 [V] or [2, V]")
    _known(regime)
    tensors = (acc, group_ids, codes, mask) + ((lut,) if lut is not None else ())
    if not on_cuda(*tensors):
        return acc.copy_(distinct_fold_plain(acc, group_ids, codes, mask, cap, lut))
    require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    g = acc.numel() // cap
    hll = lut is not None and lut.dim() == 2
    mode = _mode(regime or distinct_regime(g, cap, hll), g * cap * 4)
    if lut is None:
        idx_ptr, rank_ptr, v = None, None, _NO_LUT_V
    elif lut.dim() == 1:
        idx_ptr, rank_ptr, v = lut.data_ptr(), None, lut.shape[0]
    else:
        idx_ptr, rank_ptr, v = lut[0].data_ptr(), lut[1].data_ptr(), lut.shape[1]
    lib = LIBRARY.load()
    with torch.cuda.device(acc.device):
        err = lib.distinct_fold(
            group_ids.data_ptr(), codes.data_ptr(), codes.element_size(), mask.data_ptr(),
            idx_ptr, rank_ptr, v, cap, g, n, acc.data_ptr(), mode,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "distinct_fold")
    LAUNCHES["distinct_fold"] += 1
    return acc


# ---------------------------------------------------------------------- K6


def pct_regime(num_groups: int) -> str:
    """"compact" up to COMPACT_G_MAX groups, else "global". On an H100
    (PERF.md) it beat the earlier "shared" and "global" at the main path's
    G = 8 and G = 64 and matched "global" where every CTA's rows spread over
    more groups than its copy holds; both stay selectable with `regime=`."""
    return "compact" if num_groups <= COMPACT_G_MAX else "global"


def pct_bins(mag: torch.Tensor) -> torch.Tensor:
    """The magnitude bin of f32 log2|v| values, in the JAX fold's f32
    arithmetic: clipped, shifted, scaled, truncated toward zero, clamped."""
    mag = torch.clamp(mag, PCT_LO, PCT_HI)
    return torch.clamp(((mag - PCT_LO) * PCT_SCALE).to(torch.int32), 0, BINS - 1)


def pct_slots(vals: torch.Tensor) -> torch.Tensor:
    """The DEVICE_NB slot of each f32 value: its magnitude bin, split by
    sign, 0 in its own slot. Subnormal values count as 0, as the JAX fold's
    XLA programs treat them (its TPU and CPU backends flush them to zero)."""
    mag = vals.abs()
    bins = pct_bins(torch.log2(mag))
    return torch.where(mag < F32_TINY, 2 * BINS, torch.where(vals > 0, BINS + bins, bins))


def pct_histogram_plain(
    acc: torch.Tensor, vals: torch.Tensor, group_ids: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """acc f32 [G * DEVICE_NB] plus a count of 1 in slot
    `group_id * DEVICE_NB + pct_slots(v)` for each live row whose value is
    not NaN (ids outside [0, G) drop)."""
    g = acc.numel() // DEVICE_NB
    live = mask & ~torch.isnan(vals) & (group_ids >= 0) & (group_ids < g)
    flat = torch.where(live, group_ids.long() * DEVICE_NB + pct_slots(vals), g * DEVICE_NB)
    return _spare(acc).index_add_(0, flat, live.float())[:-1]


def pct_histogram(
    acc: torch.Tensor,
    vals: torch.Tensor,
    group_ids: torch.Tensor,
    mask: torch.Tensor,
    *,
    regime: str | None = None,
) -> torch.Tensor:
    """K6: add one block's counts into acc f32 [G * DEVICE_NB] IN PLACE and
    return it. vals f32 [N], group_ids int32 [N], mask bool [N] (row live and
    value non-null; NaN values are dropped here)."""
    require(acc.dtype == torch.float32 and acc.dim() == 1, "acc must be f32 [G * DEVICE_NB]")
    require(acc.numel() % DEVICE_NB == 0 and acc.numel() > 0, "acc must hold G * DEVICE_NB entries")
    require(vals.dtype == torch.float32 and vals.dim() == 1, "vals must be f32 [N]")
    n = vals.shape[0]
    check_ids(group_ids, n)
    require(mask.dtype == torch.bool and tuple(mask.shape) == (n,), "mask must be bool [N]")
    _known(regime)
    if not on_cuda(acc, vals, group_ids, mask):
        return acc.copy_(pct_histogram_plain(acc, vals, group_ids, mask))
    require(all(t.is_contiguous() for t in (acc, vals, group_ids, mask)), "inputs must be contiguous")
    g = acc.numel() // DEVICE_NB
    mode = _mode(regime or pct_regime(g), g * DEVICE_NB * 4)
    lib = LIBRARY.load()
    with torch.cuda.device(acc.device):
        err = lib.pct_histogram(
            vals.data_ptr(), group_ids.data_ptr(), mask.data_ptr(), g, n, PCT_LO, PCT_HI,
            PCT_SCALE, acc.data_ptr(), mode, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "pct_histogram")
    LAUNCHES["pct_histogram"] += 1
    return acc


# ---------------------------------------------------------------------- K7


def m2_regime(q: int, num_groups: int) -> str:
    """"compact" where a thread's column holds the [Q, G] cells (Q <= 2 and
    Q * G <= M2_COMPACT_CELLS: the main path's Q = 2, G = 8; on an H100,
    PERF.md, 12 us against "shared"'s 20.6), else "shared" where the [Q, G]
    sums and means fit shared memory, else "global"."""
    if q <= 2 and q * num_groups <= M2_COMPACT_CELLS:
        return "compact"
    return "shared" if 2 * q * num_groups * 4 <= SMEM_BUDGET else "global"


def centered_m2_plain(
    group_ids: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    mean: torch.Tensor,
) -> torch.Tensor:
    """m2 f32 [Q, G]: per group, the sum over rows that are live (mask), valid
    and inside [0, G) of (v - mean[q, id])^2, in f64, cast to f32."""
    q, g = mean.shape
    inside = (group_ids >= 0) & (group_ids < g)
    ids = torch.where(inside, group_ids, 0).long()
    live = valid & (mask & inside)[None, :]
    d = torch.where(live, vals.double() - mean.double()[:, ids], 0.0)
    out = torch.zeros((q, g + 1), dtype=torch.float64, device=vals.device)
    out.index_add_(1, torch.where(inside, ids, g), d * d)
    return out[:, :g].float()


def centered_m2(
    group_ids: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    mean: torch.Tensor,
    *,
    regime: str | None = None,
) -> torch.Tensor:
    """K7: group_ids int32 [N], vals f32 [Q, N], valid bool [Q, N], mask
    bool [N], mean f32 [Q, G] -> m2 f32 [Q, G]."""
    require(vals.dtype == torch.float32 and vals.dim() == 2, "vals must be f32 [Q, N]")
    q, n = vals.shape
    check_ids(group_ids, n)
    require(valid.dtype == torch.bool and tuple(valid.shape) == (q, n), "valid must be bool [Q, N]")
    require(mask.dtype == torch.bool and tuple(mask.shape) == (n,), "mask must be bool [N]")
    require(mean.dtype == torch.float32 and mean.dim() == 2 and mean.shape[0] == q,
            "mean must be f32 [Q, G]")
    require(mean.shape[1] >= 1, "mean needs at least one group")
    if not on_cuda(group_ids, vals, valid, mask, mean):
        return centered_m2_plain(group_ids, vals, valid, mask, mean)
    tensors = (group_ids, vals, valid, mask, mean)
    require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    g = mean.shape[1]
    regime = regime or m2_regime(q, g)
    require(regime != "compact" or m2_regime(q, g) == "compact",
            f"[{q}, {g}] cells do not fit a compact K7 thread's column")
    mode = _mode(regime, 2 * q * g * 4)
    out = torch.empty((q, g), dtype=torch.float32, device=vals.device)  # zeroed by the entry
    if q == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(out.device):
        err = lib.centered_m2(
            vals.data_ptr(), valid.data_ptr(), mask.data_ptr(), group_ids.data_ptr(),
            mean.data_ptr(), q, g, n, out.data_ptr(), mode, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "centered_m2")
    LAUNCHES["centered_m2"] += 1
    return out
