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

The kernel runs in one of two regimes, chosen per shape by
`topk_regime(G, k)`:

- "block" (k <= TOPK_BLOCK_MAX_K, G <= TOPK_BLOCK_MAX_G): one launch. Each
  CTA of `block_grid(G, SMs)` picks its contiguous slice's top min(k,
  slice) in shared memory (a radix select on the 32-bit score, ties at the
  cut in index order), and the last CTA to finish merges the candidates the
  same way, ranks the k winners and gathers their columns.
  `topk_block_model` is that pick in plain PyTorch.
- "radix" (every k up to TOPK_MAX_K): 12 dependent launches, a grid-wide
  MSB radix select over a G-sized u64 key array, a compaction, a bitonic
  sort and a gather.

A wrapper given CPU tensors computes `topk_groups_plain` (torch ops, and
`ops/kernels.py topk` for the pick); given CUDA tensors it launches the
kernel or raises `KernelError`, with no fallback. `LAUNCHES` counts calls
that launched it.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from parseable_tpu_torch.ops import kernels
from parseable_tpu_torch.ops.cuda_lib import CudaLibrary, KernelError, check, on_cuda, require

__all__ = [
    "KernelError", "LAUNCHES", "TOPK_BLOCK_MAX_K", "TOPK_MAX_K", "block_grid", "rows_for",
    "topk_block_model", "topk_groups", "topk_groups_plain", "topk_regime",
]

TOPK_MAX_K = 4096  # csrc kMaxK: the k keys a CTA sorts in shared memory
STATE_WORDS = 264  # csrc sizeof(State) / 4: the "radix" regime's select state
TOPK_BLOCK_MAX_K = 128  # csrc kBlockMaxK: the "block" regime's largest k
# the "block" regime's largest G: a slice's scores (4 B a group) and the
# merge's candidates (8 B each) fit the merging CTA's shared memory on a card
# of 132 SMs (31.8 KB and 135 KB at 2^20 groups, k = 128)
TOPK_BLOCK_MAX_G = 1 << 20
BLOCK_THREADS = 512  # csrc kBlockThreads
REGIMES = ("block", "radix")
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
    lib.topk_block.argtypes = [p, i, ll, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.topk_block.restype = i
    lib.topk_radix.argtypes = [p, i, ll, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.topk_radix.restype = i


LIBRARY = CudaLibrary("topk.cu", _bind)

# the "block" regime's ticket of each (device, stream): zeroed once, and reset
# by the merging CTA at the end of every call
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def topk_regime(g: int, k: int) -> str:
    """K8's regime for G groups and k picks (module docstring): "block"
    where the candidates of every CTA fit the merging CTA's shared memory,
    "radix" otherwise. Timed on both sides of its edge on an H100 (PERF.md)."""
    return "block" if k <= TOPK_BLOCK_MAX_K and g <= TOPK_BLOCK_MAX_G else "radix"


def block_grid(g: int, sms: int) -> tuple[int, int]:
    """(CTAs, groups a CTA) of the "block" regime on a card of `sms` SMs: at
    most one CTA an SM and about a group a thread; every CTA gets a group."""
    ctas = max(1, min(-(-g // BLOCK_THREADS), sms))
    size = -(-g // ctas)
    return -(-g // size), size


def block_cut_model(words: torch.Tensor, live: torch.Tensor, m: int) -> tuple[int, int, int]:
    """csrc `block_cut` in plain PyTorch: (prefix, mask, remaining) of the m
    largest u32 `words` (int64) among the `live` items, the lower position
    first among equal words; an MSB radix select, 8 bits a pass, stopping
    when the bucket it lands in holds exactly the items still needed."""
    prefix = mask = 0
    remaining = m
    if m >= words.numel():
        return prefix, mask, remaining
    for shift in (24, 16, 8, 0):
        match = live & ((words & mask) == prefix)
        hist = torch.bincount((words[match] >> shift) & 0xFF, minlength=256).tolist()
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= remaining:
                break
            above += hist[digit]
        prefix |= digit << shift
        mask |= 0xFF << shift
        remaining -= above
        if hist[digit] == remaining:
            break
    return prefix, mask, remaining


def block_take_model(words: torch.Tensor, live: torch.Tensor, cut: tuple[int, int, int]
                     ) -> torch.Tensor:
    """csrc `block_take` in plain PyTorch: the positions the cut picks, in
    position order."""
    prefix, mask, remaining = cut
    w = words & mask
    tied = live & (w == prefix)
    rank = torch.cumsum(tied.to(torch.int64), 0) - 1
    return torch.nonzero((live & (w > prefix)) | (tied & (rank < remaining))).flatten()


def topk_block_model(score: torch.Tensor, k: int, size: int) -> torch.Tensor:
    """The "block" regime's pick in plain PyTorch: int32 scores [G] -> ids
    int32 [k], largest first, ties to the lower index. Slices of `size`
    groups each give their top min(k, slice), in index order, padded to
    min(k, size) slots; the merge cuts the candidates the same way (pads
    never picked) and ranks the k winners by their u64 keys."""
    g = score.numel()
    score = score.to(torch.int64)
    keys = score * 2**32 + (2**32 - 1 - torch.arange(g))  # signed order = csrc's u64 order
    stride = min(k, size)
    cand, live = [], []
    for lo in range(0, g, size):
        words = score[lo:lo + size] + 2**31
        m = min(k, words.numel())
        picked = block_take_model(words, torch.ones_like(words, dtype=torch.bool),
                                  block_cut_model(words, torch.ones_like(words, dtype=torch.bool), m))
        cand.append(torch.cat([keys[lo + picked], keys.new_zeros(stride - m)]))
        live.append(torch.arange(stride) < m)
    cand, live = torch.cat(cand), torch.cat(live)
    words = (cand >> 32) + 2**31
    top = cand[block_take_model(words, live, block_cut_model(words, live, k))]
    top = torch.sort(top, descending=True).values
    return (2**32 - 1 - (top & (2**32 - 1))).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    with _TICKETS_LOCK:
        key = (dev.index, stream)
        if key not in _TICKETS:
            _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
        return _TICKETS[key]


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
    acc: torch.Tensor, kind: str, val_row: int, pac_row: int, sq_row: int, desc: bool, k: int,
    *, regime: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: acc f32 [R, G] -> (acc[:, idx] f32 [R, k], idx int32 [k]), the
    k groups with the largest sort keys of `kind` (rows `val_row`,
    `pac_row`, `sq_row`), largest first, ties to the lower index.

    `regime` overrides `topk_regime` (tests, timing); a regime the shape
    does not fit raises."""
    require(acc.dtype == torch.float32 and acc.dim() == 2, "acc must be f32 [R, G]")
    require(kind in KINDS, f"unknown aggregate kind {kind!r}")
    r, g = acc.shape
    require(all(0 <= x < r for x in (val_row, pac_row, sq_row)), "rows outside the accumulator")
    require(1 <= k <= min(g, TOPK_MAX_K), f"k must be in [1, min(G, {TOPK_MAX_K})]")
    regime = regime or topk_regime(g, k)
    require(regime in REGIMES, f"unknown regime {regime!r}")
    require(regime != "block" or k <= TOPK_BLOCK_MAX_K,
            f"the block regime takes k <= {TOPK_BLOCK_MAX_K}")
    if not on_cuda(acc):
        return topk_groups_plain(acc, kind, val_row, pac_row, sq_row, desc, k)
    require(acc.is_contiguous(), "acc must be contiguous")
    require(g < 2**31, "G must be below 2^31")
    dev = acc.device
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    out = torch.empty((r, k), dtype=torch.float32, device=dev)
    key_mode, null_mode = KINDS[kind]
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        head = (acc.data_ptr(), r, g, key_mode, null_mode, val_row, pac_row, sq_row, int(desc), k)
        if regime == "block":
            ctas, size = block_grid(g, _sms(dev.index))
            cand = torch.empty(ctas * min(k, size), dtype=torch.int64, device=dev)
            err = lib.topk_block(*head, ctas, size, cand.data_ptr(), _ticket(dev, stream).data_ptr(),
                                 idx.data_ptr(), out.data_ptr(), stream)
        else:
            keys = torch.empty(g, dtype=torch.int64, device=dev)
            state = torch.empty(STATE_WORDS, dtype=torch.int32, device=dev)
            sel = torch.empty(k, dtype=torch.int64, device=dev)
            err = lib.topk_radix(*head, keys.data_ptr(), state.data_ptr(), sel.data_ptr(),
                                 idx.data_ptr(), out.data_ptr(), stream)
    check(err, f"topk_groups ({regime})")
    LAUNCHES["topk_groups"] += 1
    return out, idx
