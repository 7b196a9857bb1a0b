"""The device mesh's combine (K10) as a hand-written CUDA kernel: build,
bind, launch, and plain version.

`mesh_combine(parts, desc)` combines the D per-shard partials of a mesh,
stacked on the combining device as parts f32 [D, R, W], into one f32 [R, W]:
each row by its op in `desc` (one `(op, n_row, s_row)` a row): SUM, MIN,
MAX, or M2, Chan's two-psum recentre of centred second moments whose counts
and sums sit in rows `n_row` and `s_row`. It replaces the XLA collectives
of the JAX package's mesh branches: psum / pmin / pmax in
`parseable_tpu/parallel/mesh.py:91-95` and `query/executor_tpu.py`
:2533-2539 and :2982-2987, the distinct `pmax` (:2948), the histogram
`psum` (:2980) and `_psum_m2` (:917-934). Source and design notes:
`csrc/mesh.cu`.

The copies of the partials between devices are plain tensor copies (the
counterpart of JAX's ICI transfers), not part of the kernel.

A wrapper given CPU tensors computes `mesh_combine_plain`; given CUDA
tensors it launches the kernel or raises `KernelError`, with no fallback.
`LAUNCHES` counts calls that launched it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from parseable_tpu_torch.ops.cuda_lib import CudaLibrary, KernelError, check, on_cuda, require

__all__ = ["KernelError", "LAUNCHES", "M2", "MAX", "MIN", "SUM", "mesh_combine",
           "mesh_combine_plain"]

SUM, MIN, MAX, M2 = range(4)  # csrc enum Op
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CANONICAL_NAN = 0x7FC00000

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"mesh_combine": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mesh_combine.argtypes = [p, p, p, i, i, ll, p]
    lib.mesh_combine.restype = i


LIBRARY = CudaLibrary("mesh.cu", _bind)


def _check_desc(desc: Sequence[tuple[int, int, int]], rows: int) -> None:
    require(len(desc) == rows, f"desc names {len(desc)} rows, parts hold {rows}")
    for op, n_row, s_row in desc:
        require(op in (SUM, MIN, MAX, M2), f"unknown op {op}")
        require(op != M2 or (0 <= n_row < rows and 0 <= s_row < rows), "M2 rows outside parts")


def bound_ms(d: int, r: int, w: int) -> float:
    """The least time the card could take: (D + 1) R W 4 bytes over the
    H100's memory rate."""
    return (d + 1) * r * w * 4 / HBM_BYTES_PER_S * 1e3


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Kernel B's order of f32 values as int32 (-0.0 below +0.0)."""
    b = x.view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _floor1(n: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 1.0, n, 1.0)


def mesh_combine_plain(parts: torch.Tensor, desc: Sequence[tuple[int, int, int]]) -> torch.Tensor:
    """K10 in torch ops, one op at a time in the kernel's order, so that the
    card's run of it gives the kernel's bits."""
    d_count, rows, _ = parts.shape
    out = torch.empty(parts.shape[1:], dtype=torch.float32, device=parts.device)
    for r, (op, n_row, s_row) in enumerate(desc):
        p = parts[:, r]
        if op == SUM:
            acc = p[0].clone()
            for d in range(1, d_count):
                acc = acc + p[d]
        elif op in (MIN, MAX):
            acc = p[0].clone()
            nan = torch.isnan(acc)
            for d in range(1, d_count):
                x = p[d]
                nan |= torch.isnan(x)
                kx, ka = _order_key(x), _order_key(acc)
                acc = torch.where(kx < ka if op == MIN else kx > ka, x, acc)
            nan_bits = torch.tensor(CANONICAL_NAN, dtype=torch.int32, device=parts.device)
            acc = torch.where(nan, nan_bits.view(torch.float32), acc)
        else:
            pn, ps = parts[:, n_row], parts[:, s_row]
            n_t, s_t = pn[0].clone(), ps[0].clone()
            for d in range(1, d_count):
                n_t = n_t + pn[d]
                s_t = s_t + ps[d]
            mean_t = s_t / _floor1(n_t)
            acc = torch.zeros_like(n_t)
            for d in range(d_count):
                n_d = pn[d]
                dev = ps[d] / _floor1(n_d) - mean_t
                term = p[d] + (n_d * dev) * dev
                acc = torch.where(n_d > 0.0, acc + term, acc)
        out[r] = acc
    return out


_DESC_CACHE: dict[tuple, torch.Tensor] = {}
_DESC_LOCK = threading.Lock()


def _desc_on(device: torch.device, desc: Sequence[tuple[int, int, int]]) -> torch.Tensor:
    """The row descriptors as int32 [R, 3] on `device`, copied once per
    (device, descriptors): a layout's descriptors serve every block."""
    key = (str(device), tuple(map(tuple, desc)))
    with _DESC_LOCK:
        t = _DESC_CACHE.get(key)
        if t is None:
            t = torch.tensor(key[1], dtype=torch.int32).reshape(-1, 3).to(device)
            _DESC_CACHE[key] = t
        return t


def mesh_combine(parts: torch.Tensor, desc: Sequence[tuple[int, int, int]]) -> torch.Tensor:
    """K10: parts f32 [D, R, W] (the D shards' partials on one device) ->
    f32 [R, W], row r combined by desc[r] = (op, n_row, s_row)."""
    require(parts.dtype == torch.float32 and parts.dim() == 3, "parts must be f32 [D, R, W]")
    d_count, rows, width = parts.shape
    require(d_count >= 1 and rows >= 1 and width >= 1, "parts must be non-empty")
    _check_desc(desc, rows)
    if not on_cuda(parts):
        return mesh_combine_plain(parts, desc)
    require(parts.is_contiguous(), "parts must be contiguous")
    require(rows <= 65535, "at most 65,535 rows")
    out = torch.empty((rows, width), dtype=torch.float32, device=parts.device)
    lib = LIBRARY.load()
    with torch.cuda.device(parts.device):
        dt = _desc_on(parts.device, desc)
        err = lib.mesh_combine(parts.data_ptr(), dt.data_ptr(), out.data_ptr(), d_count, rows,
                               width, torch.cuda.current_stream().cuda_stream)
    check(err, "mesh_combine")
    LAUNCHES["mesh_combine"] += 1
    return out
