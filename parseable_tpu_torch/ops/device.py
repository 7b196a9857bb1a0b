"""Host <-> device columnar encoding.

Copied from `parseable_tpu/ops/device.py` (the encoder is host-only). The
device wants fixed-width dtypes and no strings, and the executor keeps a few
block shapes. This module turns pyarrow columns into device-friendly
ndarrays:

- numerics -> float32 (+ validity mask). Where a query asks for
  `f64_name(column)` (a WHERE compares it with a number), a column whose
  values are all exact in f32 is listed in `exact_cols`, and any other
  also encodes as an f64 copy, which the WHERE compares exactly
  (aggregates keep the f32 values)
- timestamps -> int32 MILLISECONDS relative to a per-batch day-aligned
  origin (exact ms comparison/bin semantics on device); the origin depends
  only on the batch's data, so encodings stay query-independent and
  hot-set cacheable, and per-batch deltas ship as runtime scalars
- strings -> host-side dictionary encode; int32 codes go to device, the
  dictionary stays on host. String predicates (=, LIKE, regex) evaluate over
  the (small) dictionary once, then become an O(1) boolean LUT gather on
  device — this is why the "regex filter over 10 GB of logs" benchmark maps
  so well to the device: the regex runs over unique values only.
- rows are padded to power-of-two block sizes, so the executor sees a
  handful of block shapes, not one per batch. Padding rows carry mask=0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

# Max |rel| for encoded time values: headroom below int32 so the device
# bin shift (+ origin%bin_ms, itself < 2^30) can never wrap
TIME_REL_SPAN = (1 << 30) - 1


def pow2_block(n: int, minimum: int = 1024, maximum: int = 1 << 22) -> int:
    b = minimum
    while b < n and b < maximum:
        b <<= 1
    return b


@dataclass
class EncodedColumn:
    """One column ready for device transfer."""

    name: str
    kind: str  # "num" | "dict" | "time" | "bool"
    values: np.ndarray  # float32/int32 data or int32 codes
    valid: np.ndarray  # bool validity
    dictionary: list[Any] | None = None  # host-side dict values (kind=dict)
    all_valid: bool = False  # True -> `valid` need not ship to device
    vmin: int | None = None  # time cols: min/max of valid values (rel units)
    vmax: int | None = None

    @property
    def cardinality(self) -> int:
        return len(self.dictionary) if self.dictionary is not None else 0


@dataclass
class EncodedBatch:
    """A padded row block: every column padded to `block_rows`."""

    num_rows: int
    block_rows: int
    columns: dict[str, EncodedColumn]
    row_mask: np.ndarray  # bool [block_rows]; False on padding
    # day-aligned per-batch time origin; "time" column values are int32 ms
    # relative to this
    time_origin_ms: int = 0
    # numeric columns whose f64 copy was asked for and is not needed: every
    # value is exact in f32
    exact_cols: set[str] = field(default_factory=set)


# name suffix of a numeric column's f64 copy (EncodedColumn kind "f64")
F64_SUFFIX = "#f64"


def f64_name(name: str) -> str:
    return name + F64_SUFFIX


def f64_base(name: str) -> str | None:
    """The column an f64 copy's name is for (None for another name)."""
    return name[: -len(F64_SUFFIX)] if name.endswith(F64_SUFFIX) else None


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(a) == n:
        return a
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _code_dtype(card: int) -> np.dtype:
    """Narrowest dtype holding codes 0..card (card = null/padding slot):
    transfer bytes are the cold-scan budget, and a 64-value dictionary's
    codes fit a byte. Device gathers accept any integer index dtype."""
    if card <= 127:
        return np.dtype(np.int8)
    if card <= 32767:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def encode_column(
    name: str,
    col: pa.ChunkedArray | pa.Array,
    block_rows: int,
    time_origin_ms: int,
    force_dict: bool = False,
) -> EncodedColumn | None:
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    t = col.type
    all_valid = col.null_count == 0
    if all_valid:
        valid = np.ones(block_rows, dtype=bool)
        valid[len(col) :] = False
    else:
        valid = np.asarray(pc.is_valid(col).to_numpy(zero_copy_only=False), dtype=bool)
        valid = _pad(valid, block_rows, False)
    # padding rows are invalid, but a fully-populated block still ships no mask
    all_valid = all_valid and len(col) == block_rows

    if force_dict and not (
        pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_dictionary(t)
    ):
        # group-by keys of any type become dictionary codes (GROUP BY status
        # on a float column, GROUP BY a bool flag, ...)
        denc = pc.dictionary_encode(col)
        if isinstance(denc, pa.ChunkedArray):
            denc = denc.combine_chunks()
        codes = np.asarray(denc.indices.fill_null(-1).to_numpy(zero_copy_only=False)).astype(np.int64)
        dictionary = denc.dictionary.to_pylist()
        codes = np.where(codes < 0, len(dictionary), codes).astype(_code_dtype(len(dictionary)))
        return EncodedColumn(
            name,
            "dict",
            _pad(codes, block_rows, len(dictionary)),
            valid,
            dictionary + [None],
            all_valid=all_valid,
        )
    if pa.types.is_timestamp(t):
        raw = np.asarray(pc.cast(col, pa.int64()).fill_null(0).to_numpy(zero_copy_only=False))
        if str(t).startswith("timestamp[us"):
            if len(raw) and (raw % 1000).any():
                # sub-ms residue would floor away: the device's ms values
                # could then satisfy predicates the true values don't —
                # decline the column, CPU compares at full precision
                return None
            ms = raw // 1000
        elif str(t).startswith("timestamp[ns"):
            if len(raw) and (raw % 1_000_000).any():
                return None
            ms = raw // 1_000_000
        elif str(t).startswith("timestamp[s"):
            ms = raw * 1000
        else:
            ms = raw
        rel = ms - time_origin_ms
        # null slots rebase to the block origin (rel 0): they are masked by
        # `valid`, and the epoch-0 fill would blow the rel-span guard for
        # every block once the origin is per-block ms
        if not all_valid:
            rel = np.where(valid[: len(rel)], rel, 0)
        if len(rel) and (rel.min() < -TIME_REL_SPAN or rel.max() > TIME_REL_SPAN):
            return None  # would wrap int32 -> caller takes the CPU path
        vals = _pad(rel.astype(np.int32), block_rows)
        if col.null_count == len(col):
            vmin = vmax = None
        elif col.null_count == 0:
            vmin, vmax = int(rel.min()) if len(rel) else None, int(rel.max()) if len(rel) else None
        else:
            live = rel[np.asarray(pc.is_valid(col).to_numpy(zero_copy_only=False), bool)]
            vmin, vmax = (int(live.min()), int(live.max())) if len(live) else (None, None)
        return EncodedColumn(
            name, "time", vals, valid, all_valid=all_valid, vmin=vmin, vmax=vmax
        )
    if pa.types.is_boolean(t):
        vals = np.asarray(col.fill_null(False).to_numpy(zero_copy_only=False), dtype=np.float32)
        return EncodedColumn(name, "bool", _pad(vals, block_rows), valid, all_valid=all_valid)
    if pa.types.is_integer(t) or pa.types.is_floating(t):
        vals = np.asarray(
            pc.cast(col, pa.float64()).fill_null(0.0).to_numpy(zero_copy_only=False)
        ).astype(np.float32)
        return EncodedColumn(name, "num", _pad(vals, block_rows), valid, all_valid=all_valid)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        denc = pc.dictionary_encode(col)
        if isinstance(denc, pa.ChunkedArray):
            denc = denc.combine_chunks()
        codes = np.asarray(denc.indices.fill_null(-1).to_numpy(zero_copy_only=False)).astype(np.int64)
        # null -> extra slot at end so gathers stay in-bounds
        dictionary = denc.dictionary.to_pylist()
        codes = np.where(codes < 0, len(dictionary), codes).astype(_code_dtype(len(dictionary)))
        return EncodedColumn(
            name,
            "dict",
            _pad(codes, block_rows, len(dictionary)),
            valid,
            dictionary + [None],
            all_valid=all_valid,
        )
    if pa.types.is_dictionary(t):
        codes = np.asarray(col.indices.fill_null(-1).to_numpy(zero_copy_only=False)).astype(np.int64)
        dictionary = col.dictionary.to_pylist()
        codes = np.where(codes < 0, len(dictionary), codes).astype(_code_dtype(len(dictionary)))
        return EncodedColumn(
            name,
            "dict",
            _pad(codes, block_rows, len(dictionary)),
            valid,
            dictionary + [None],
            all_valid=all_valid,
        )
    return None  # unsupported (lists, nested) -> caller falls back to CPU


def encode_f64(name: str, col: pa.ChunkedArray | pa.Array, block_rows: int) -> EncodedColumn | None:
    """The f64 copy of a numeric column (named `f64_name(name)`), or None
    where f64 does not hold its values exactly either (integers past
    2^53): a WHERE over it then declines the block."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    t = col.type
    if not (pa.types.is_integer(t) or pa.types.is_floating(t)):
        return None
    if pa.types.is_integer(t) and len(col) - col.null_count:
        lo, hi = pc.min_max(col).values()
        if max(abs(lo.as_py()), abs(hi.as_py())) > 2**53:
            return None
    wide = np.asarray(pc.cast(col, pa.float64()).fill_null(0.0).to_numpy(zero_copy_only=False))
    all_valid = col.null_count == 0 and len(col) == block_rows
    valid = _pad(np.asarray(pc.is_valid(col).to_numpy(zero_copy_only=False), dtype=bool), block_rows, False)
    return EncodedColumn(f64_name(name), "f64", _pad(wide, block_rows), valid, all_valid=all_valid)


DAY_MS = 86_400_000


def _batch_time_origin(table: pa.Table) -> int:
    """Day-aligned floor of the batch's earliest live timestamp, across
    ALL time columns — deliberately independent of the query's column
    subset, so the same source block always encodes with the same origin
    and enccache variant merges never thrash on origin mismatches. Day
    alignment means `origin % bin_ms == 0` for every sub-day bin, and the
    per-block rel values (minute-bucketed blocks span minutes) sit
    comfortably inside TIME_REL_SPAN."""
    lo: int | None = None
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if not pa.types.is_timestamp(t):
            continue
        m = pc.cast(pc.min(col), pa.int64()).as_py()  # int in the col's unit
        if m is None:
            continue
        if str(t).startswith("timestamp[us"):
            m //= 1000
        elif str(t).startswith("timestamp[ns"):
            m //= 1_000_000
        elif str(t).startswith("timestamp[s"):
            m *= 1000
        lo = m if lo is None else min(lo, m)
    if lo is None:
        return 0
    return (lo // DAY_MS) * DAY_MS


def encode_table(
    table: pa.Table,
    needed: set[str] | None,
    block_rows: int | None = None,
    dict_columns: set[str] | None = None,
) -> EncodedBatch | None:
    """Encode a table for device execution; None if a needed column can't be.

    `dict_columns` forces dictionary encoding (group-by keys of any type).
    A name `f64_name(c)` in `needed` lists numeric column c in
    `exact_cols` where its values are all exact in f32, and else adds its
    f64 copy. With `needed` None (every column: the upload seed) every
    exact numeric column is listed, and no f64 copy is made: the first
    query that compares such a column writes its copy behind.
    Timestamps encode as int32 MILLISECONDS relative to a per-batch
    day-aligned origin (VERDICT r4 #10): exact ms semantics on device for
    every comparison op, sub-second literals, and ms-granularity bins.
    The origin depends only on the batch's own data, so encodings stay
    query-independent and hot-set/enccache cacheable; per-batch origin
    deltas ship to the device as tiny runtime scalars (never baked into
    the fold), so one fold serves every block.
    """
    n = table.num_rows
    block = block_rows or pow2_block(n)
    origin = _batch_time_origin(table)
    cols: dict[str, EncodedColumn] = {}
    exact: set[str] = set()
    for name in table.column_names:
        if needed is not None and name not in needed:
            continue
        enc = encode_column(
            name,
            table.column(name),
            block,
            origin,
            force_dict=bool(dict_columns and name in dict_columns),
        )
        if enc is None:
            return None
        cols[name] = enc
        asked = needed is not None and f64_name(name) in needed
        if enc.kind == "num" and (asked or needed is None):
            wide = encode_f64(name, table.column(name), block)
            if wide is None:
                continue  # neither f32 nor f64 holds it: its compares decline
            if np.all((enc.values == wide.values) | np.isnan(wide.values)):
                exact.add(name)
            elif asked:
                cols[wide.name] = wide
    mask = np.zeros(block, dtype=bool)
    mask[:n] = True
    return EncodedBatch(
        num_rows=n,
        block_rows=block,
        columns=cols,
        row_mask=mask,
        time_origin_ms=origin,
        exact_cols=exact,
    )
