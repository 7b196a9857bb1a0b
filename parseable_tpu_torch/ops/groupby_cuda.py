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

Beside each wrapper is its plain PyTorch version (`*_plain`). A wrapper
given CPU tensors computes the plain version; given CUDA tensors it launches
the kernel or raises. The tests and `chip_smoke.py` compare the two.

The library is compiled with nvcc for sm_90a at first use into
`build/kernels/` at the repository root and loaded with ctypes (plain C
interface, no PyTorch headers). `LAUNCHES` counts kernel launches per
wrapper, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

F32_MAX = 3.4e38

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "groupby.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"additive_groupby": 0, "minmax_groupby": 0}

_lib = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, refused its launch or got bad inputs."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Built library for the current source (named by its content hash, so
    an edited source never loads a stale build)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgroupby_{digest[:16]}.so"


def build() -> Path:
    """Compile csrc/groupby.cu unless the library for this source exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.additive_groupby.argtypes = [p, p, p, i, ll, i, p]
            lib.additive_groupby.restype = i
            lib.minmax_groupby.argtypes = [p, p, p, p, p, p, i, i, ll, i, p]
            lib.minmax_groupby.restype = i
            _lib = lib
        return _lib


def build_and_load() -> float:
    """Build (if needed) and load the kernels; returns the seconds taken."""
    t0 = time.perf_counter()
    _load()
    return time.perf_counter() - t0


def _check(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelError(msg)


def _check_ids(group_ids: torch.Tensor, n: int) -> None:
    _require(group_ids.dtype == torch.int32, f"group_ids must be int32, got {group_ids.dtype}")
    _require(group_ids.dim() == 1 and group_ids.shape[0] == n, "group_ids must be [N]")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; a mix raises."""
    kinds = {t.device for t in tensors}
    _require(len(kinds) == 1, f"tensors on several devices: {sorted(map(str, kinds))}")
    dev = kinds.pop()
    _require(dev.type in ("cuda", "cpu"), f"unsupported device {dev}")
    return dev.type == "cuda"


# ---------------------------------------------------------------- kernel A


def additive_groupby_plain(group_ids: torch.Tensor, rows: torch.Tensor, num_groups: int) -> torch.Tensor:
    """out[R, G] = per-group sums of each row (ids outside [0, G) dropped)."""
    inside = (group_ids >= 0) & (group_ids < num_groups)
    ids = torch.where(inside, group_ids, 0)
    out = torch.zeros((rows.shape[0], num_groups), dtype=torch.float32, device=rows.device)
    out.index_add_(1, ids, torch.where(inside[None, :], rows, 0.0))
    return out


def additive_groupby(group_ids: torch.Tensor, rows: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Kernel A: group_ids int32 [N], rows f32 [R, N] -> f32 [R, num_groups]."""
    _require(rows.dtype == torch.float32 and rows.dim() == 2, "rows must be f32 [R, N]")
    r, n = rows.shape
    _check_ids(group_ids, n)
    _require(num_groups >= 1, "num_groups must be >= 1")
    if not _on_cuda(group_ids, rows):
        return additive_groupby_plain(group_ids, rows, num_groups)
    _require(group_ids.is_contiguous() and rows.is_contiguous(), "inputs must be contiguous")
    out = torch.zeros((r, num_groups), dtype=torch.float32, device=rows.device)
    if r == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.additive_groupby(
            group_ids.data_ptr(), rows.data_ptr(), out.data_ptr(), r, n, num_groups, stream
        )
    _check(err, "additive_groupby")
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


def minmax_groupby(
    group_ids: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
    n_min: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: group_ids int32 [N], vals f32 [K, N], valid bool [K, N],
    mask bool [N] -> (min f32 [n_min, G], max f32 [K - n_min, G])."""
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
    out = torch.empty((k, num_groups), dtype=torch.float32, device=vals.device)
    if k == 0:
        return out[:n_min], out[n_min:]
    keys = torch.empty((k, num_groups), dtype=torch.int32, device=vals.device)
    lib = _load()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.minmax_groupby(
            group_ids.data_ptr(), vals.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keys.data_ptr(), out.data_ptr(), k, n_min, n, num_groups, stream,
        )
    _check(err, "minmax_groupby")
    LAUNCHES["minmax_groupby"] += 1
    return out[:n_min], out[n_min:]
