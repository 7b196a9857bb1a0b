"""Hand-written CUDA group-by kernels: build, bind, launch, and plain versions.

Two kernels reduce one scanned block into its per-group partial aggregate
(sources and design notes in `csrc/groupby.cu`):

- `additive_groupby(group_ids, rows, G)` — kernel A, `out[R, G] = rows @
  onehot(group_ids)`; the counterpart of
  `parseable_tpu/ops/pallas_groupby.py:53 additive_groupby_pallas`;
- `minmax_groupby(group_ids, vals, valid, mask, G, n_min)` — kernel B,
  per-group min of the first `n_min` value rows and max of the rest, the
  counterpart of the segment_min/segment_max half of
  `parseable_tpu/ops/kernels.py:108 fused_groupby_block`.

Kernel A runs in one of three regimes, chosen per shape by
`additive_regime(R, G)`; what bounds each on an H100 and what its design
does about it:

- "tensor" (R <= 8, G <= 128, the one-hot product's tensor-core
  operations bound under the bytes bound, ceil16(G) * 24 <= 590 (R + 1),
  and fewer 16-group m-tiles than value rows):
  the Pallas kernel's formula on the tensor cores with `mma.sync`
  (bf16 one-hot built in registers, each f32 row split by truncation into
  three exact bf16 pieces, f32 accumulators). Bound by its mma issue,
  which grows with G; no atomic in the row loop, so skewed ids cost nothing.
  NaN and +-inf values take an atomic side path into their own group.
  `bf16_split` and `additive_groupby_tensor_model` are its arithmetic in
  plain PyTorch.
- "shared" (R * G * 4 bytes fit in shared memory): a per-CTA accumulator
  with warp-adaptive aggregated shared atomics, as many CTAs as the card
  holds at once.
- "global": the same loads and warp-adaptive aggregation, the sums into a
  group-major record [G, record_width(R)] in global memory, so that a row's
  R values (R <= 4) are one 16-byte vector reduction
  (`red.global.add.v4.f32`) into one L2 sector; a second launch lays the
  record out as [R, G]. What bounds it is the L2's random operations, not
  the bytes: the card does about the same number of them a second whatever
  their width, and the record takes one a row where [R, G] took R.

Kernel B folds order-preserving u32 keys with the same warp-adaptive
aggregation (`__match_any_sync`, then a max over the peers by shuffles),
one memset and one launch whose last CTA decodes the keys; past
`MINMAX_DECODE_IN_KERNEL` entries (`minmax_decode(K, G)`) the decode is a
launch of its own, so that one CTA does not walk them alone.

Beside each wrapper is its plain PyTorch version (`*_plain`). A wrapper
given CPU tensors computes the plain version; given CUDA tensors it launches
the kernel or raises. The tests and `chip_smoke.py` compare the two.

The library is compiled with nvcc for sm_90a at first use into
`build/kernels/` at the repository root and loaded with ctypes (plain C
interface, no PyTorch headers; `ops/cuda_lib.py`). `LAUNCHES` counts kernel
launches per wrapper, so a run can show that the main path went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from parseable_tpu_torch.ops.cuda_lib import CudaLibrary, KernelError
from parseable_tpu_torch.ops.cuda_lib import check as _check
from parseable_tpu_torch.ops.cuda_lib import check_ids as _check_ids
from parseable_tpu_torch.ops.cuda_lib import on_cuda as _on_cuda
from parseable_tpu_torch.ops.cuda_lib import require as _require

__all__ = ["KernelError", "LAUNCHES", "additive_groupby", "minmax_groupby"]

F32_MAX = 3.4e38
SMEM_BUDGET = 200 * 1024  # dynamic shared memory a CTA may ask for (csrc kSmemCap)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
TC_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
TC_MAX_ROWS = 8  # value rows of one n-tile
TC_MAX_GROUPS = 128  # 8 m-tiles of 16 groups
TC_COLS = 24  # three bf16 pieces x 8 value rows: the product's N
REGIMES = {"tensor": 0, "shared": 1, "global": 2}
MINMAX_DECODE_IN_KERNEL = 2048  # key entries kernel B's last CTA decodes itself
DECODES = {"launch": 0, "kernel": 1}

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"additive_groupby": 0, "minmax_groupby": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.additive_groupby.argtypes = [p, p, p, p, i, ll, i, i, p]
    lib.additive_groupby.restype = i
    lib.minmax_groupby.argtypes = [p, p, p, p, p, p, i, i, ll, i, i, p]
    lib.minmax_groupby.restype = i


LIBRARY = CudaLibrary("groupby.cu", _bind)


# ---------------------------------------------------------------- kernel A


def additive_groupby_plain(group_ids: torch.Tensor, rows: torch.Tensor, num_groups: int) -> torch.Tensor:
    """out[R, G] = per-group sums of each row (ids outside [0, G) dropped)."""
    inside = (group_ids >= 0) & (group_ids < num_groups)
    ids = torch.where(inside, group_ids, 0)
    out = torch.zeros((rows.shape[0], num_groups), dtype=torch.float32, device=rows.device)
    out.index_add_(1, ids, torch.where(inside[None, :], rows, 0.0))
    return out


def additive_regime(r: int, g: int) -> str:
    """Kernel A's regime for R value rows and G groups (module docstring).

    "tensor" where the one-hot product is cheaper than the atomic regimes:
    its operations bound under its bytes bound (2 * ceil16(G) * 24
    operations per row at 989 TFLOP/s against 4 (R + 1) bytes at 3.35 TB/s,
    i.e. ceil16(G) * 24 <= 590 (R + 1)) and fewer 16-group m-tiles than
    value rows. The tensor regime's time grows with its m-tiles (three mma
    and four compares per m-tile and 16 rows) and not with the ids; the
    shared regime's grows with R (a shared atomic per row and nonzero value)
    and with collisions. The rule sees the shape only, and it is fitted to
    spread ids: timed on both sides of its edge on an H100 (PERF.md), it
    picks the faster regime on uniform ids, or the tensor one where the two
    are within 2% (R=3 G=32, R=5 G=64). On skewed ids the tensor regime is
    faster at every shape it fits, by 1.5-2.3x where the rule picks shared
    (R=3 G=48-64, R=5 G=80-96). "shared" where the [R, G] accumulator fits
    in shared memory; "global" otherwise."""
    m_tiles = -(-g // 16)
    ops_per_byte = TC_BF16_OPS_PER_S / HBM_BYTES_PER_S
    if (
        r <= TC_MAX_ROWS
        and g <= TC_MAX_GROUPS
        and 2 * 16 * m_tiles * TC_COLS <= ops_per_byte * 4 * (r + 1)
        and m_tiles < r
    ):
        return "tensor"
    if r * g * 4 <= SMEM_BUDGET:
        return "shared"
    return "global"


def record_width(r: int) -> int:
    """Floats of a group's record in the "global" regime: R rounded up to
    whole 16-byte vectors."""
    return 4 * -(-r // 4)


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 -> (hi, mid, lo) f32 tensors, split by truncation as the tensor
    regime splits its rows: hi = x & 0xFFFF0000, mid = trunc16(x - hi),
    lo = x - hi - mid. hi + mid + lo == x exactly for every finite x; each
    piece is exact in bf16 for |x| >= 2^-110 (below that, lo drops the bits
    under 2^-133)."""

    def trunc16(v: torch.Tensor) -> torch.Tensor:
        return (v.view(torch.int32) & -65536).view(torch.float32)

    hi = trunc16(x)
    d = x - hi
    mid = trunc16(d)
    return hi, mid, d - mid


def additive_groupby_tensor_model(
    group_ids: torch.Tensor, rows: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """The tensor regime's arithmetic in plain PyTorch: a bf16 one-hot
    times each row's three bf16 pieces, summed in f32, the pieces added last;
    non-finite values enter the product as 0 and their own group directly."""
    finite = torch.isfinite(rows)
    pieces = bf16_split(torch.where(finite, rows, 0.0))
    inside = (group_ids >= 0) & (group_ids < num_groups)
    onehot = (
        group_ids[:, None].long() == torch.arange(num_groups, device=rows.device)[None, :]
    ) & inside[:, None]
    onehot = onehot.to(torch.bfloat16).to(torch.float32)
    hi, mid, lo = (p.to(torch.bfloat16).to(torch.float32) @ onehot for p in pieces)
    out = (lo + mid) + hi
    if not bool(finite.all()):
        out += additive_groupby_plain(group_ids, torch.where(finite, 0.0, rows), num_groups)
    return out


def additive_groupby(
    group_ids: torch.Tensor,
    rows: torch.Tensor,
    num_groups: int,
    *,
    regime: str | None = None,
) -> torch.Tensor:
    """Kernel A: group_ids int32 [N], rows f32 [R, N] -> f32 [R, num_groups].

    `regime` overrides `additive_regime` (tests, timing); a regime the shape
    does not fit raises."""
    _require(rows.dtype == torch.float32 and rows.dim() == 2, "rows must be f32 [R, N]")
    r, n = rows.shape
    _check_ids(group_ids, n)
    _require(num_groups >= 1, "num_groups must be >= 1")
    if not _on_cuda(group_ids, rows):
        return additive_groupby_plain(group_ids, rows, num_groups)
    _require(group_ids.is_contiguous() and rows.is_contiguous(), "inputs must be contiguous")
    regime = regime or additive_regime(r, num_groups)
    _require(regime in REGIMES, f"unknown regime {regime!r}")
    if r == 0 or n == 0:
        return torch.zeros((r, num_groups), dtype=torch.float32, device=rows.device)
    # zeroed by the entry, or written whole by the global regime's layout launch
    out = torch.empty((r, num_groups), dtype=torch.float32, device=rows.device)
    # the global regime's scratch record, zeroed by the entry
    record = (torch.empty((num_groups, record_width(r)), dtype=torch.float32, device=rows.device)
              if regime == "global" else None)
    lib = LIBRARY.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.additive_groupby(
            group_ids.data_ptr(), rows.data_ptr(), None if record is None else record.data_ptr(),
            out.data_ptr(), r, n, num_groups, REGIMES[regime], stream,
        )
    _check(err, f"additive_groupby ({regime})")
    LAUNCHES["additive_groupby"] += 1
    return out


# ---------------------------------------------------------------- kernel B


def minmax_groupby_plain(
    group_ids: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
    n_min: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(min f32 [n_min, G], max f32 [K - n_min, G]): masked or invalid rows
    contribute +-F32_MAX, groups no row reaches keep +-inf."""
    k, n = vals.shape
    inside = (group_ids >= 0) & (group_ids < num_groups)
    live = valid & mask[None, :]
    # rows outside [0, G) scatter into a spare last group that is cut off
    ids = torch.where(inside, group_ids, num_groups).to(torch.int64)
    index = ids[None, :].expand(k, n)

    def reduce(part: slice, sentinel: float, fill: float, how: str) -> torch.Tensor:
        v = torch.where(live[part], vals[part], sentinel)
        out = torch.full((v.shape[0], num_groups + 1), fill, dtype=torch.float32, device=vals.device)
        out.scatter_reduce_(1, index[part], v, reduce=how, include_self=True)
        return out[:, :num_groups]

    mins = reduce(slice(0, n_min), F32_MAX, float("inf"), "amin")
    maxs = reduce(slice(n_min, k), -F32_MAX, float("-inf"), "amax")
    return mins, maxs


def minmax_decode(k: int, g: int) -> str:
    """Where kernel B decodes its K*G keys: "kernel", in its last CTA, up to
    MINMAX_DECODE_IN_KERNEL entries (no launch of its own), else "launch", a
    decode launch over the whole card. Timed both ways on an H100 at K=2
    (PERF.md): the last CTA wins up to 1,024 entries, the two tie at 4,096,
    and past that one CTA walking the keys alone loses (by 2.5 us at 8,192
    entries and 61 us at 131,072)."""
    return "kernel" if k * g <= MINMAX_DECODE_IN_KERNEL else "launch"


def minmax_groupby(
    group_ids: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
    n_min: int,
    *,
    decode: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: group_ids int32 [N], vals f32 [K, N], valid bool [K, N],
    mask bool [N] -> (min f32 [n_min, G], max f32 [K - n_min, G]).

    `decode` overrides `minmax_decode` (tests, timing)."""
    _require(vals.dtype == torch.float32 and vals.dim() == 2, "vals must be f32 [K, N]")
    k, n = vals.shape
    _check_ids(group_ids, n)
    _require(valid.dtype == torch.bool and tuple(valid.shape) == (k, n), "valid must be bool [K, N]")
    _require(mask.dtype == torch.bool and tuple(mask.shape) == (n,), "mask must be bool [N]")
    _require(0 <= n_min <= k and num_groups >= 1, "bad n_min or num_groups")
    if not _on_cuda(group_ids, vals, valid, mask):
        return minmax_groupby_plain(group_ids, vals, valid, mask, num_groups, n_min)
    _require(
        all(t.is_contiguous() for t in (group_ids, vals, valid, mask)), "inputs must be contiguous"
    )
    decode = decode or minmax_decode(k, num_groups)
    _require(decode in DECODES, f"unknown decode {decode!r}")
    out = torch.empty((k, num_groups), dtype=torch.float32, device=vals.device)
    if k == 0:
        return out[:n_min], out[n_min:]
    keys = torch.empty(k * num_groups + 1, dtype=torch.int32, device=vals.device)
    lib = LIBRARY.load()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.minmax_groupby(
            group_ids.data_ptr(), vals.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keys.data_ptr(), out.data_ptr(), k, n_min, n, num_groups, DECODES[decode], stream,
        )
    _check(err, "minmax_groupby")
    LAUNCHES["minmax_groupby"] += 1
    return out[:n_min], out[n_min:]
