"""HyperLogLog register sketch for approx_distinct, shared by both engines.

Own copy of `parseable_tpu/ops/hll_sketch.py`:

- CPU engine: `registers_add` folds (unique) values into a [M] uint8
  register file per group;
- GPU engine: a block's dictionary values hash once on the host into
  (index, rank) LUTs (`luts_for_dictionary`); on the card the distinct
  kernel maxes `rank_lut[code]` into register `group_id * M + idx_lut[code]`
  of a flat f32 file, the same mergeable shape as the count(distinct)
  presence bitmaps.

Registers merge by elementwise max (associative, commutative, idempotent),
so device partials and CPU-fallback partials combine exactly. The estimator
is the standard bias-corrected HLL with linear counting for the small range.

The hash of a value is xxHash64 (seed 0) of `str(value).encode()`, as the
JAX package computes it with its native library. `xxh64_many` is the same
hash over a whole dictionary in numpy uint64 lanes (one pass per 8-byte
word position, not one Python call per value), bit-identical to
`parseable_tpu_torch.event.format.xxh64`.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

import numpy as np

from parseable_tpu_torch.event.format import xxh64

HLL_P = 12  # 4096 registers: ~1.6% standard error, 4 KB/group dense
HLL_M = 1 << HLL_P

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)
# rows of one padded byte matrix: bounds the scratch of a long dictionary
_CHUNK_BYTES = 1 << 24


def value_hash(v: Any) -> int:
    return xxh64(str(v).encode())


def hash_to_idx_rank(h: int) -> tuple[int, int]:
    """Register index = top P bits; rank = leading-zeros(+1) of the rest."""
    idx = h >> (64 - HLL_P)
    rest = (h << HLL_P) & 0xFFFFFFFFFFFFFFFF
    # clz(rest) + 1 for a 64-bit value; all-zero rest saturates at 64-P+1
    rank = (64 - rest.bit_length() + 1) if rest else (64 - HLL_P + 1)
    return idx, rank


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _round(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _rotl(acc + lane * _P2, 31) * _P1


def _xxh64_rows(words: np.ndarray, mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """xxHash64 (seed 0) of each row of `mat` (uint8 [n, W], zero padded,
    W a multiple of 32 with 8 spare bytes), `lens` bytes long; `words` is
    `mat` viewed as little-endian uint64 [n, W / 8]."""
    n = len(lens)
    lens64 = lens.astype(np.uint64)
    stripes = lens // 32
    v1 = np.full(n, _P1 + _P2, np.uint64)
    v2 = np.full(n, _P2, np.uint64)
    v3 = np.zeros(n, np.uint64)
    v4 = np.full(n, np.uint64(0) - _P1, np.uint64)
    for s in range(int(stripes.max(initial=0))):
        live = stripes > s
        lanes = words[:, 4 * s : 4 * s + 4]
        v1 = np.where(live, _round(v1, lanes[:, 0]), v1)
        v2 = np.where(live, _round(v2, lanes[:, 1]), v2)
        v3 = np.where(live, _round(v3, lanes[:, 2]), v3)
        v4 = np.where(live, _round(v4, lanes[:, 3]), v4)
    h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
    for v in (v1, v2, v3, v4):
        h = (h ^ _round(np.zeros(n, np.uint64), v)) * _P1 + _P4
    h = np.where(stripes > 0, h, _P5) + lens64
    pos = stripes * 32  # byte offset of the tail
    rows = np.arange(n)
    for _ in range(3):  # up to three 8-byte words after the stripes
        live = pos + 8 <= lens
        k = words[rows, np.minimum(pos // 8, words.shape[1] - 1)]  # pos is 8-aligned here
        h = np.where(live, _rotl(h ^ _round(np.zeros(n, np.uint64), k), 27) * _P1 + _P4, h)
        pos = np.where(live, pos + 8, pos)
    live = pos + 4 <= lens
    at = pos[:, None] + np.arange(4)
    word4 = np.take_along_axis(mat, np.minimum(at, mat.shape[1] - 1), 1).astype(np.uint64)
    k4 = word4[:, 0] | word4[:, 1] << np.uint64(8) | word4[:, 2] << np.uint64(16) | word4[:, 3] << np.uint64(24)
    h = np.where(live, _rotl(h ^ (k4 * _P1), 23) * _P2 + _P3, h)
    pos = np.where(live, pos + 4, pos)
    for _ in range(3):  # up to three single bytes
        live = pos < lens
        b = mat[rows, np.minimum(pos, mat.shape[1] - 1)].astype(np.uint64)
        h = np.where(live, _rotl(h ^ (b * _P5), 11) * _P1, h)
        pos = np.where(live, pos + 1, pos)
    h ^= h >> np.uint64(33)
    h *= _P2
    h ^= h >> np.uint64(29)
    h *= _P3
    return h ^ (h >> np.uint64(32))


def xxh64_many(items: list[bytes]) -> np.ndarray:
    """xxHash64 (seed 0) of every byte string, as uint64 [len(items)].

    Strings are bucketed by their count of 32-byte stripes, and each bucket
    is hashed as one zero-padded byte matrix in numpy uint64 lanes, in
    chunks of at most `_CHUNK_BYTES` bytes of matrix."""
    n = len(items)
    out = np.zeros(n, np.uint64)
    if not n:
        return out
    lens = np.fromiter(map(len, items), np.int64, n)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    data = np.frombuffer(b"".join(items) + bytes(8), np.uint8)
    buckets = lens // 32
    with np.errstate(over="ignore"):
        for b in np.unique(buckets):
            sel = np.nonzero(buckets == b)[0]
            width = int(b) * 32 + 40  # the bucket's longest string, padded
            step = max(1, _CHUNK_BYTES // width)
            for c in range(0, len(sel), step):
                rows = sel[c : c + step]
                at = starts[rows, None] + np.arange(width)
                mat = data[np.minimum(at, len(data) - 1)]
                mat[np.arange(width)[None, :] >= lens[rows, None]] = 0
                out[rows] = _xxh64_rows(mat.view("<u8"), mat, lens[rows])
    return out


def idx_rank_many(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`hash_to_idx_rank` over uint64 hashes: (idx int32, rank int32)."""
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int32)
    rest = h << np.uint64(HLL_P)
    hi = (rest >> np.uint64(32)).astype(np.float64)
    lo = (rest & np.uint64(0xFFFFFFFF)).astype(np.float64)
    # bit length of a value below 2^32 is frexp's exponent (exact in f64)
    bits = np.where(hi > 0, 32 + np.frexp(hi)[1], np.frexp(lo)[1])
    rank = np.where(rest == 0, 64 - HLL_P + 1, 64 - bits + 1).astype(np.int32)
    return idx, rank


def luts_for_dictionary(dictionary: list) -> tuple[np.ndarray, np.ndarray]:
    """Per-block LUTs for dict-encoded columns: (idx int32[N], rank
    int32[N]). The trailing null slot (and any None) gets rank 0, a no-op
    against zero-initialized registers. One vectorized hash over the whole
    dictionary (`xxh64_many`): a per-value Python hash would cost
    microseconds a value on exactly the high-cardinality blocks this sketch
    exists for."""
    n = len(dictionary)
    nulls = np.fromiter((v is None for v in dictionary), bool, n)
    items = [b"" if v is None else str(v).encode() for v in dictionary]
    idx, rank = idx_rank_many(xxh64_many(items))
    idx[nulls] = 0
    rank[nulls] = 0
    return idx, rank


def registers_add(regs: np.ndarray | None, values: Iterable[Any]) -> np.ndarray:
    """Fold values into a [M] uint8 register file (CPU engine)."""
    if regs is None:
        regs = np.zeros(HLL_M, dtype=np.uint8)
    for v in values:
        if v is None:
            continue
        ix, rk = hash_to_idx_rank(value_hash(v))
        if rk > regs[ix]:
            regs[ix] = rk
    return regs


def merge_registers(a: np.ndarray | None, b: np.ndarray | None) -> np.ndarray | None:
    """Elementwise max. COPIES on the single-sided paths: the result may
    be mutated by registers_add, and aliasing a donor aggregator's array
    would corrupt it (merge-twice / merge-then-update)."""
    if a is None:
        return None if b is None else b.copy()
    if b is None:
        return a.copy()
    return np.maximum(a, b)


_ALPHA = 0.7213 / (1.0 + 1.079 / HLL_M)


def estimate(regs: np.ndarray) -> float:
    """Bias-corrected estimate with linear counting for the small range."""
    regs = np.asarray(regs, dtype=np.float64)
    s = np.power(2.0, -regs).sum()
    e = _ALPHA * HLL_M * HLL_M / s
    zeros = int((regs == 0).sum())
    if e <= 2.5 * HLL_M and zeros > 0:
        return HLL_M * math.log(HLL_M / zeros)
    return float(e)


def estimate_many(regs: np.ndarray) -> np.ndarray:
    """Vectorized estimate over [G, M] register files."""
    regs = np.asarray(regs, dtype=np.float64)
    s = np.power(2.0, -regs).sum(axis=1)
    e = _ALPHA * HLL_M * HLL_M / s
    zeros = (regs == 0).sum(axis=1)
    small = (e <= 2.5 * HLL_M) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lc = HLL_M * np.log(HLL_M / np.maximum(zeros, 1))
    return np.where(small, lc, e)
