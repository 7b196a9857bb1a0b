"""Build, load and check the port's hand-written CUDA libraries.

Each kernel source under `parseable_tpu_torch/csrc/` is one shared library
with a plain C interface: compiled with nvcc for sm_90a at first use into
`build/kernels/` at the repository root, named by the hash of its source,
the shared headers (`csrc/*.cuh`) and the flags (an edited source or header
never loads a stale build), and loaded with ctypes. `build_all(libraries)`
starts one nvcc per source at once, so a cold start pays for the slowest
build, not for their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


class CudaLibrary:
    """One source file's library: `bind` sets the ctypes signatures of its
    entry points once it is loaded."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless the library for it exists."""
        out = self.library_path()
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def build_all(libraries: list[CudaLibrary]) -> float:
    """Build (one nvcc per source, all at once) and load `libraries`;
    returns the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        list(pool.map(CudaLibrary.load, libraries))
    return time.perf_counter() - t0


def check(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelError(msg)


def check_ids(group_ids: torch.Tensor, n: int) -> None:
    require(group_ids.dtype == torch.int32, f"group_ids must be int32, got {group_ids.dtype}")
    require(group_ids.dim() == 1 and group_ids.shape[0] == n, "group_ids must be [N]")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; a mix raises."""
    kinds = {t.device for t in tensors}
    require(len(kinds) == 1, f"tensors on several devices: {sorted(map(str, kinds))}")
    dev = kinds.pop()
    require(dev.type in ("cuda", "cpu"), f"unsupported device {dev}")
    return dev.type == "cuda"
