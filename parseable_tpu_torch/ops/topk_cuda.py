"""The device top-k (K8) as a hand-written CUDA kernel: build, bind, launch,
and plain version.

`topk_groups(acc, kind, val_row, pac_row, sq_row, desc, k)` picks, from the
dense accumulator acc f32 [R, G], the k groups with the largest sort keys of
one aggregate and gathers their columns: (acc[:, idx] f32 [R, k], idx int32
[k]). It is the counterpart of the XLA program of
`parseable_tpu/query/executor_tpu.py:2165 _run_topk_program` (`run`,
:2199-2246) with `parseable_tpu/ops/kernels.py:71 topk` (`lax.top_k`). The
sort key of a group is `kind`'s value (the value row, avg = sum / max(pac,
1), var = max(M2 / (max(pac, 2) - 1), 0), stddev = its sqrt, in f32), its
f32 bits mapped to a monotone int32 (negated for an ascending order), with
NaN keys, then NULL aggregates, then empty slots below every real key. Ties
go to the lower index, as in `lax.top_k`; `torch.topk` on CUDA promises no
order among ties. Source and design notes: `csrc/topk.cu`.

A wrapper given CPU tensors computes `topk_groups_plain` (torch ops, and
`ops/kernels.py topk` for the pick); given CUDA tensors it launches the
kernel or raises `KernelError`, with no fallback. `LAUNCHES` counts calls
that launched it.
"""

from __future__ import annotations

import ctypes

import torch

from parseable_tpu_torch.ops import kernels
from parseable_tpu_torch.ops.cuda_lib import CudaLibrary, KernelError, check, on_cuda, require

__all__ = ["KernelError", "LAUNCHES", "TOPK_MAX_K", "rows_for", "topk_groups", "topk_groups_plain"]

TOPK_MAX_K = 4096  # csrc kMaxK: the k keys a CTA sorts in shared memory
STATE_WORDS = 264  # csrc sizeof(State) / 4
# kind -> (key mode, NULL mode) of csrc's score: the value row itself, avg,
# var, stddev; NULL where pac is 0, where pac is below 2, where count is 0
KINDS = {
    "sum": (0, 0), "min": (0, 0), "max": (0, 0), "avg": (1, 0),
    "var": (2, 1), "stddev": (3, 1), "count": (0, 2), "count_star": (0, 2),
}
NAN_SCORE = -2139095339  # below the least real key, -inf's -2139095040
NULL_SCORE = -2147483647
EMPTY_SCORE = -2147483648

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"topk_groups": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_groups.argtypes = [p, i, ll, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.topk_groups.restype = i


LIBRARY = CudaLibrary("topk.cu", _bind)


def rows_for(lay, kind: str, si: int) -> tuple[int, int, int]:
    """(value row, pac row, M2 row) that K8 reads for aggregate `si` of
    `kind` in a packed accumulator of layout `lay` (the GPU executor's
    AccLayout). count and count(*) order by their count row."""
    pac_row = lay.pac_row(si) if kind != "count_star" else 0
    val_row = {"sum": lay.sum_row, "avg": lay.sum_row, "stddev": lay.sqx_row, "var": lay.sqx_row,
               "min": lay.min_row, "max": lay.max_row}.get(kind, lambda _: pac_row)(si)
    return val_row, pac_row, lay.sqm2_row(si) if kind in ("stddev", "var") else 0


def scores_plain(
    acc: torch.Tensor, kind: str, val_row: int, pac_row: int, sq_row: int, desc: bool
) -> torch.Tensor:
    """The int32 sort score of every group (JAX :2201-2244), in torch ops."""
    count, pacv = acc[0], acc[pac_row]
    if kind == "avg":
        keyv = acc[val_row] / torch.maximum(pacv, pacv.new_tensor(1.0))
    elif kind in ("var", "stddev"):
        n = torch.maximum(pacv, pacv.new_tensor(2.0))
        keyv = torch.maximum(acc[sq_row] / (n - 1.0), pacv.new_tensor(0.0))
        if kind == "stddev":
            keyv = torch.sqrt(keyv)
    else:
        keyv = acc[val_row]
    if kind in ("sum", "avg", "min", "max"):
        notnull = pacv > 0
    elif kind in ("var", "stddev"):
        notnull = pacv > 1  # n < 2: a NULL variance
    else:
        notnull = count > 0
    occupied = count > 0
    live = occupied & notnull
    nan = torch.isnan(keyv)
    bits = keyv.contiguous().view(torch.int32).to(torch.int64)
    u = torch.where(bits >= 0, bits, -(2**31) - bits)
    o = u if desc else torch.where(u == -(2**31), 2**31 - 1, -u)
    score = torch.where(
        live & ~nan,
        o,
        torch.where(live, NAN_SCORE, torch.where(occupied, NULL_SCORE, EMPTY_SCORE)),
    )
    return score.to(torch.int32)


def topk_groups_plain(
    acc: torch.Tensor, kind: str, val_row: int, pac_row: int, sq_row: int, desc: bool, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 in torch ops: (acc[:, idx] f32 [R, k], idx int32 [k])."""
    score = scores_plain(acc, kind, val_row, pac_row, sq_row, desc)
    _, idx = kernels.topk(score, k)
    return acc[:, idx], idx.to(torch.int32)


def topk_groups(
    acc: torch.Tensor, kind: str, val_row: int, pac_row: int, sq_row: int, desc: bool, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: acc f32 [R, G] -> (acc[:, idx] f32 [R, k], idx int32 [k]), the
    k groups with the largest sort keys of `kind` (rows `val_row`,
    `pac_row`, `sq_row`), largest first, ties to the lower index."""
    require(acc.dtype == torch.float32 and acc.dim() == 2, "acc must be f32 [R, G]")
    require(kind in KINDS, f"unknown aggregate kind {kind!r}")
    r, g = acc.shape
    require(all(0 <= x < r for x in (val_row, pac_row, sq_row)), "rows outside the accumulator")
    require(1 <= k <= min(g, TOPK_MAX_K), f"k must be in [1, min(G, {TOPK_MAX_K})]")
    if not on_cuda(acc):
        return topk_groups_plain(acc, kind, val_row, pac_row, sq_row, desc, k)
    require(acc.is_contiguous(), "acc must be contiguous")
    require(g < 2**31, "G must be below 2^31")
    dev = acc.device
    keys = torch.empty(g, dtype=torch.int64, device=dev)
    state = torch.empty(STATE_WORDS, dtype=torch.int32, device=dev)
    sel = torch.empty(k, dtype=torch.int64, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    out = torch.empty((r, k), dtype=torch.float32, device=dev)
    key_mode, null_mode = KINDS[kind]
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.topk_groups(
            acc.data_ptr(), r, g, key_mode, null_mode, val_row, pac_row, sq_row, int(desc), k,
            keys.data_ptr(), state.data_ptr(), sel.data_ptr(), idx.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "topk_groups")
    LAUNCHES["topk_groups"] += 1
    return out, idx
