"""Native plain-JSON ingest lane: ctypes over the port's own C++ library.

Counterpart of `parseable_tpu/native/__init__.py`, trimmed to the plain-JSON
ladder (`fastpath.cpp` beside this file): the single-pass columnar parse
(JSON payload -> Arrow-layout buffers imported zero-copy, optionally split
over a native worker pool) and the NDJSON tier below it.

The library is built with g++ at first use into `build/native/` at the
repository root, named by the hash of the source, the flags and what
`-march=native` means on this machine (a build copied to another CPU never
loads), written under a temporary name and renamed, with a file lock so
concurrent processes build it once. There is no silent fallback: a missing
compiler, a failed build or a missing export raises `NativeError`. Only a
shape decline (the C side's return code) sends a payload down a tier.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import pyarrow as pa

SOURCE = Path(__file__).resolve().parent / "fastpath.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the compiler command; tests point it elsewhere to prove a failed build raises
COMPILER = "g++"
# -fno-semantic-interposition: exported C symbols stay overridable-safe while
# intra-library calls inline (interposition semantics cost ~6x on the parse
# hot loops under -fPIC)
CXX_FLAGS = (
    "-O3", "-march=native", "-fno-semantic-interposition",
    "-fPIC", "-shared", "-pthread", "-std=c++17",
)
# worker slices of one columnar parse, and the payload size below which it
# parses on one core (split/stitch bookkeeping costs more than it saves on
# small bodies); the JAX package's defaults
PARSE_SHARDS = min(os.cpu_count() or 1, 4)
SHARD_MIN_BYTES = 256 * 1024
MAX_SHARDS = 16  # the C side clamps too

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


class NativeError(RuntimeError):
    """The native library could not be built, loaded or bound."""


def _compiler() -> str:
    found = shutil.which(COMPILER)
    if found is None:
        raise NativeError(f"C++ compiler {COMPILER!r} not found: the native ingest lane needs it")
    return found


def _target_tag(cxx: str) -> str:
    """What `-march=native` expands to here, as the compiler reports it."""
    proc = subprocess.run(
        [cxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull, "-o", os.devnull],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise NativeError(f"{COMPILER} -march=native failed ({proc.returncode}): {proc.stderr[-2000:]}")
    for line in proc.stderr.splitlines():
        at = line.find(" -march=")
        if at >= 0:
            return line[at:]
    return ""


def library_path(build_dir: Path | None = None) -> Path:
    cxx = _compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_target_tag(cxx).encode())
    return (build_dir or BUILD_DIR) / f"libptpu_torch_fastpath_{h.hexdigest()[:16]}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile the source unless the library for it exists; returns its path."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if out.is_file():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeError(f"{COMPILER} could not run: {e}") from e
        if proc.returncode != 0 or not tmp.is_file():
            tmp.unlink(missing_ok=True)
            raise NativeError(f"{COMPILER} failed on {SOURCE.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every export's signature (restype AND argtypes: ctypes
    defaults a missing restype to c_int, which truncates 64-bit returns)."""
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    sigs = {
        "ptpu_flatten_ndjson": (ctypes.c_int, [
            ctypes.c_char_p, u64, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(vp), ctypes.POINTER(u64), ctypes.POINTER(u64),
        ]),
        "ptpu_free": (None, [vp]),
        "ptpu_flatten_columnar": (ctypes.c_int, [
            ctypes.c_char_p, u64, ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(vp),
        ]),
        "ptpu_flatten_columnar_sharded": (ctypes.c_int, [
            ctypes.c_char_p, u64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(vp),
        ]),
        "ptpu_cols_nrows": (u64, [vp]),
        "ptpu_cols_ncols": (ctypes.c_uint32, [vp]),
        "ptpu_cols_name": (ctypes.c_char_p, [vp, ctypes.c_uint32]),
        "ptpu_cols_kind": (ctypes.c_int32, [vp, ctypes.c_uint32]),
        "ptpu_cols_null_count": (u64, [vp, ctypes.c_uint32]),
        "ptpu_cols_validity": (vp, [vp, ctypes.c_uint32]),
        "ptpu_cols_data": (vp, [vp, ctypes.c_uint32]),
        "ptpu_cols_data_len": (u64, [vp, ctypes.c_uint32]),
        "ptpu_cols_offsets": (vp, [vp, ctypes.c_uint32]),
        "ptpu_cols_free": (None, [vp]),
        "ptpu_cols_live": (ctypes.c_longlong, []),
        "ptpu_parse_pool_shutdown": (None, []),
        "ptpu_parse_pool_size": (ctypes.c_int, []),
    }
    for name, (restype, argtypes) in sigs.items():
        try:
            fn = getattr(lib, name)
        except AttributeError as e:
            raise NativeError(f"the native library lacks the export {name}") from e
        fn.restype = restype
        fn.argtypes = argtypes


def load() -> ctypes.CDLL:
    """The bound library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeError(f"the native library {path} does not load: {e}") from e
            _bind(lib)
            _lib = lib
        return _lib


def flatten_ndjson(payload: bytes, max_depth: int, separator: str = "_") -> tuple[bytes, int] | None:
    """Parse + flatten a JSON ingest payload straight to NDJSON
    (`ptpu_flatten_ndjson`). Returns (ndjson_bytes, nrows), or None when the
    payload needs the exact Python flatten path (arrays, sparse/duplicate
    keys, over-depth nesting, nonstandard tokens) or is malformed (the
    Python lane's json.loads then gives the user-facing error)."""
    lib = load()
    out = ctypes.c_void_p()
    out_len = ctypes.c_uint64()
    nrows = ctypes.c_uint64()
    rc = lib.ptpu_flatten_ndjson(
        payload, len(payload), max_depth, separator.encode(),
        ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(nrows),
    )
    if rc != 0:
        return None
    try:
        data = ctypes.string_at(out.value, out_len.value)
    finally:
        lib.ptpu_free(out)
    return data, int(nrows.value)


# Column kinds crossing the ABI (fastpath.cpp's PT_COL_* enum).
_COL_NULL, _COL_F64, _COL_BOOL, _COL_STR = 0, 1, 2, 3


class _ColumnarBufs:
    """Ownership handoff for one native columnar result: every
    pa.foreign_buffer wrapping the C++ buffers keeps this object as its
    base, so the single ptpu_cols_free runs exactly when the LAST Arrow
    array referencing any of the buffers is released."""

    __slots__ = ("_h",)

    def __init__(self, h: int):
        self._h = h

    def __del__(self):
        h, self._h = self._h, None
        if h and _lib is not None:
            _lib.ptpu_cols_free(h)


def columnar_live() -> int:
    """Native columnar results not yet freed (leak detector)."""
    return 0 if _lib is None else int(_lib.ptpu_cols_live())


def _import_columnar(lib: ctypes.CDLL, handle: int) -> tuple[list[str], list[pa.Array], int]:
    """Wrap one native columnar handle as (names, arrays, nrows), zero-copy;
    the handle is freed with the last array through the owner."""
    owner = _ColumnarBufs(handle)
    nrows = int(lib.ptpu_cols_nrows(handle))
    names: list[str] = []
    arrays: list[pa.Array] = []
    for i in range(int(lib.ptpu_cols_ncols(handle))):
        names.append(lib.ptpu_cols_name(handle, i).decode())
        kind = lib.ptpu_cols_kind(handle, i)
        if kind == _COL_NULL:
            arrays.append(pa.nulls(nrows))
            continue
        nullc = int(lib.ptpu_cols_null_count(handle, i))
        vptr = lib.ptpu_cols_validity(handle, i)
        validity = pa.foreign_buffer(vptr, (nrows + 7) // 8, owner) if (nullc and vptr) else None
        dptr = lib.ptpu_cols_data(handle, i)
        dlen = int(lib.ptpu_cols_data_len(handle, i))
        data = pa.foreign_buffer(dptr, dlen, owner) if dptr else pa.allocate_buffer(0)
        if kind == _COL_F64:
            arr = pa.Array.from_buffers(pa.float64(), nrows, [validity, data], nullc)
        elif kind == _COL_BOOL:
            arr = pa.Array.from_buffers(pa.bool_(), nrows, [validity, data], nullc)
        elif kind == _COL_STR:
            offsets = pa.foreign_buffer(lib.ptpu_cols_offsets(handle, i), 4 * (nrows + 1), owner)
            arr = pa.Array.from_buffers(pa.string(), nrows, [validity, offsets, data], nullc)
        else:
            raise NativeError(f"unknown column kind {kind} from the native library")
        arrays.append(arr)
    return names, arrays, nrows


def _effective_shards(payload_len: int, shards: int | None) -> int:
    """Shard count for one parse call: an explicit `shards` wins (tests force
    counts); otherwise PARSE_SHARDS, with payloads under SHARD_MIN_BYTES on
    one core. Clamped to [1, MAX_SHARDS]."""
    if shards is None:
        if payload_len < SHARD_MIN_BYTES:
            return 1
        shards = PARSE_SHARDS
    return max(1, min(int(shards), MAX_SHARDS))


def flatten_columnar(
    payload: bytes, max_depth: int, separator: str = "_", shards: int | None = None
) -> tuple[list[str], list[pa.Array], int] | None:
    """Columnar tier: parse + flatten a plain-JSON payload straight into
    Arrow-layout column buffers in ONE pass and import them zero-copy.
    Returns (names, arrays, nrows), or None when the payload needs a lower
    tier (the NDJSON lane, then Python): arrays, mixed types, sparse keys and
    depth as the NDJSON lane, plus escaped keys, lone surrogates and other
    columnar-only declines.

    shards > 1 splits the payload at record boundaries and parses the slices
    on the native worker pool, with the GIL released; the stitched result
    (and the decline) is identical to shards=1 at any count."""
    lib = load()
    out = ctypes.c_void_p()
    rc = lib.ptpu_flatten_columnar_sharded(
        payload, len(payload), max_depth, separator.encode(),
        _effective_shards(len(payload), shards), ctypes.byref(out),
    )
    if rc != 0:
        return None
    return _import_columnar(lib, out.value)


def shutdown_parse_pool() -> None:
    """Drain and join the native parse worker pool (the server's stop);
    the pool restarts lazily on the next sharded parse."""
    if _lib is not None:
        _lib.ptpu_parse_pool_shutdown()


def parse_pool_size() -> int:
    """Live native parse-pool worker count."""
    return 0 if _lib is None else int(_lib.ptpu_parse_pool_size())
