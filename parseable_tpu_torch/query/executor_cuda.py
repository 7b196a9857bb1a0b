"""GPU query executor: predicate + dense group-by aggregation on the card.

Counterpart of `parseable_tpu/query/executor_tpu.py`, dense aggregate path
only: `_execute_aggregate_tpu` (:1485), `_dense_interim` (:2039), the fold
of `_get_program`/`fold_one` (:2762/:2852), `_flush_state` (:3159) and
`_transfer`/`_bitcast_from_u8` (:3286/:3269). Per scanned block:

1. columns encode on the host (`ops/device.py`): numerics -> f32, strings ->
   batch-local dictionary codes, timestamps -> int32 ms relative to a
   day-aligned block origin;
2. the WHERE tree's string predicates evaluate once per dictionary value
   into boolean LUTs; the group keys' batch dictionaries fold into global
   dictionaries, giving batch->global remap LUTs;
3. the encoded columns, LUTs and remaps pack into ONE pinned host buffer and
   cross to the card in ONE non_blocking copy, then are carved back into
   typed tensors with `.view(dtype)`;
4. the fold runs on the card: WHERE mask (LUT gathers, compares, IN-lists,
   time bounds), group ids `sum(code_k * stride_k)` (dict remap gathers and
   floor-divided time bins), then `fused_groupby_block` — hand kernels A and
   B — and a fold into the device accumulator by add/min/max;
5. the accumulator is read back once per capacity epoch and finalized on the
   host in f64 through the CPU engine's shared finalize and `_order_limit`.

Shapes outside this slice raise `UnsupportedOnDevice` and take the CPU
engine, counted in `route_stats["cpu_fallback"]`: aggregates other than
count/sum/avg/min/max, aggregates over expressions, group spaces beyond
`DENSE_G_MAX`, unencodable columns, and plain SELECT. A missing or failing
card raises; the executor never answers a GPU query on the CPU because the
card is unavailable.

Precision: per-block reductions run in f32 (blocks <= 2^22 rows keep counts
exact; sums carry ~1e-6 relative error against the CPU engine's f64);
cross-epoch accumulation is f64 on the host. Time compares are exact at ms.
"""

from __future__ import annotations

import logging
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import UTC, datetime, timedelta
from typing import Any, Iterator

import numpy as np
import pyarrow as pa
import torch

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.config import Options
from parseable_tpu_torch.ops import kernels
from parseable_tpu_torch.ops.device import EncodedBatch, EncodedColumn, encode_table
from parseable_tpu_torch.query import sql as S
from parseable_tpu_torch.query.executor import AggSpec, HashAggregator, QueryExecutor
from parseable_tpu_torch.query.planner import LogicalPlan
from parseable_tpu_torch.utils.devicecheck import require_device
from parseable_tpu_torch.utils.timeutil import parse_duration, parse_rfc3339

logger = logging.getLogger(__name__)

SOURCE_ID_META = b"ptpu_source_id"
# pow2_block's ceiling: tables beyond this split before encoding
MAX_BLOCK_ROWS = 1 << 22
# largest dense global group space the device accumulator holds; beyond it
# the rest of the scan aggregates on the host (block-local high-cardinality
# aggregation is later work)
DENSE_G_MAX = 1 << 19
# byte alignment of each segment in the packed transfer payload, so every
# segment can be viewed as its own dtype
_ALIGN = 16


class UnsupportedOnDevice(Exception):
    pass


def _pow2(n: int, minimum: int = 8) -> int:
    p = minimum
    while p < n:
        p <<= 1
    return p


# ------------------------------------------------------------- global dicts


class GlobalDict:
    """Union of per-batch dictionaries for one column, plus device remaps.

    Known values resolve through ONE `pc.index_in` hash probe against the
    accumulated dictionary; only new values take the Python append."""

    def __init__(self) -> None:
        self.values: list[Any] = []
        self._chunks: list[pa.Array] = []  # same values, arrow-side

    def absorb(self, batch_dict: list[Any]) -> np.ndarray:
        """Register a batch dictionary; return the batch->global int32 remap,
        padded to pow2 with a large sentinel (nulls + padding decode as the
        null group)."""
        card = len(batch_dict)
        lut = np.full(_pow2(card + 1), np.int32(2**30), dtype=np.int32)
        if card == 0:
            return lut
        import pyarrow.compute as pc

        if self.values and not self._chunks:
            # a previous batch fell back to slow mode; the arrow-side view
            # is stale, so stay on the slow path for dictionary consistency
            return self._absorb_slow(batch_dict, lut)
        try:
            batch_arr = pa.array(batch_dict)
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            return self._absorb_slow(batch_dict, lut)
        if self._chunks:
            value_set: pa.Array | pa.ChunkedArray = (
                self._chunks[0]
                if len(self._chunks) == 1
                else pa.chunked_array(self._chunks)
            )
            try:
                idx = pc.index_in(batch_arr, value_set=value_set)
            except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
                return self._absorb_slow(batch_dict, lut)
            known = idx.fill_null(-1).to_numpy(zero_copy_only=False).astype(np.int64)
        else:
            known = np.full(card, -1, dtype=np.int64)
        valid = np.asarray(pc.is_valid(batch_arr).to_numpy(zero_copy_only=False), bool)
        new_mask = (known < 0) & valid
        new_pos = np.nonzero(new_mask)[0]
        if len(new_pos):
            base = len(self.values)
            new_vals = batch_arr.take(pa.array(new_pos))
            # batch dictionaries hold unique values, so bulk-append is safe
            self.values.extend(new_vals.to_pylist())
            self._chunks.append(new_vals)
            known[new_pos] = base + np.arange(len(new_pos))
        lut[: len(known)][valid & (known >= 0)] = known[valid & (known >= 0)].astype(
            np.int32
        )
        return lut

    def _absorb_slow(self, batch_dict: list[Any], lut: np.ndarray) -> np.ndarray:
        """Mixed-type dictionaries arrow can't hash: per-value fallback."""
        index = {v: i for i, v in enumerate(self.values)}
        for i, v in enumerate(batch_dict):
            if v is None:
                continue
            gi = index.get(v)
            if gi is None:
                gi = len(self.values)
                self.values.append(v)
                index[v] = gi
            lut[i] = gi
        self._chunks = []  # arrow-side view no longer tracks .values
        return lut

    def __len__(self) -> int:
        return len(self.values)


# --------------------------------------------------------------- group keys


@dataclass
class KeySpec:
    kind: str  # "dict" | "timebin"
    column: str
    expr: S.Expr
    bin_ms: int = 0  # timebin only
    gdict: GlobalDict | None = None  # dict only
    capacity: int = 1  # current stride capacity (pow2)
    origin_rel: int | None = None  # timebin only: origin *bin index*


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern) and pattern[i + 1] in ("%", "_", "\\"):
            # backslash-escaped wildcard is a literal (matches Arrow's
            # pc.match_like semantics on the CPU path)
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def _interval_ms(e: S.Expr) -> int | None:
    if isinstance(e, S.IntervalLit):
        return int(parse_duration(e.text).total_seconds() * 1000)
    if isinstance(e, S.Literal) and isinstance(e.value, str):
        try:
            return int(parse_duration(e.value).total_seconds() * 1000)
        except ValueError:
            return None
    return None


_TRUNC_MS = {
    "second": 1000,
    "minute": 60_000,
    "hour": 3_600_000,
    "day": 86_400_000,
}


def classify_group_expr(e: S.Expr) -> KeySpec:
    """Map a GROUP BY expression onto a device key kind, or raise."""
    if isinstance(e, S.Column):
        return KeySpec("dict", e.name, e, gdict=GlobalDict())
    if isinstance(e, S.FunctionCall) and e.name == "date_bin" and len(e.args) >= 2:
        if len(e.args) > 2:
            # custom bin origin: device bins are epoch-aligned only
            raise UnsupportedOnDevice("date_bin with explicit origin")
        ms = _interval_ms(e.args[0])
        col = e.args[1]
        # any >=1ms bin maps exactly; the upper bound keeps the device-side
        # shift (origin % bin_ms + rel) inside int32
        if ms and ms <= (1 << 30) and isinstance(col, S.Column):
            return KeySpec("timebin", col.name, e, bin_ms=ms)
        raise UnsupportedOnDevice("sub-millisecond or >12-day date_bin")
    if isinstance(e, S.FunctionCall) and e.name == "date_trunc" and len(e.args) == 2:
        unit = e.args[0].value if isinstance(e.args[0], S.Literal) else None
        col = e.args[1]
        ms = _TRUNC_MS.get(str(unit).lower()) if unit else None
        if ms and isinstance(col, S.Column):
            return KeySpec("timebin", col.name, e, bin_ms=ms)
    if isinstance(e, S.Cast):
        return classify_group_expr(e.expr)
    raise UnsupportedOnDevice(f"group expression not device-mappable: {S.expr_name(e)}")


# ------------------------------------------------------------ mask compiler


class PredicateCompiler:
    """Compile a WHERE tree into device ops, in two phases per batch:

    - `collect_luts(e, enc)` (host): evaluate string predicates over the
      *batch* dictionary into boolean LUTs, padded to pow2, and time
      literals into block-relative ms. Cached on the EncodedBatch.
    - `trace(e, enc, dev, luts)` (device): emit tensor ops, consuming the
      LUT tensors and time scalars positionally in the same walk order.
    """

    # ---------------------------------------------------------- phase A

    def collect_luts(self, e: S.Expr | None, enc: EncodedBatch) -> list:
        out: list = []
        if e is not None:
            self._walk_collect(e, enc, out)
        return out

    def _walk_collect(self, e: S.Expr, enc: EncodedBatch, out: list) -> None:
        if isinstance(e, S.BinaryOp):
            if e.op in ("and", "or"):
                self._walk_collect(e.left, enc, out)
                self._walk_collect(e.right, enc, out)
                return
            if e.op in ("=", "!=", "<", "<=", ">", ">="):
                col, op, lit = self._cmp_parts(e, enc)
                if col.kind == "dict":
                    out.append(self._dict_lut(enc, col, op, lit))
                elif col.kind == "time":
                    # per-block rel-ms literal: a host int, so one fold
                    # serves every block regardless of its time origin
                    out.append(self._time_lit(enc, op, lit))
                return
            if e.op in ("like", "ilike", "not_like", "not_ilike"):
                col = self._column_of(e.left, enc)
                raw = str(self._literal_of(e.right))
                out.append(
                    self._regex_lut(
                        enc,
                        col,
                        _like_to_regex(raw),
                        re.IGNORECASE if "ilike" in e.op else 0,
                        e.op.startswith("not_"),
                    )
                )
                return
        if isinstance(e, S.UnaryOp) and e.op == "not":
            self._walk_collect(e.operand, enc, out)
            return
        if isinstance(e, S.Between):
            self._walk_collect(S.BinaryOp(">=", e.expr, e.low), enc, out)
            self._walk_collect(S.BinaryOp("<=", e.expr, e.high), enc, out)
            return
        if isinstance(e, S.InList):
            col = self._column_of(e.expr, enc)
            if col.kind == "dict":
                out.append(self._in_lut(enc, e, col))
            return
        if isinstance(e, S.FunctionCall) and e.name in ("regexp_match", "regexp_like"):
            col = self._column_of(e.args[0], enc)
            out.append(self._regex_lut(enc, col, str(self._literal_of(e.args[1])), 0, False))
            return
        if isinstance(e, (S.IsNull, S.Literal)):
            return
        raise UnsupportedOnDevice(f"predicate not device-mappable: {type(e).__name__}")

    # ---------------------------------------------------------- phase B

    def trace(self, e: S.Expr | None, enc: EncodedBatch, dev: dict, luts: list) -> torch.Tensor:
        if e is None:
            return dev["__ones"]
        return self._visit(e, enc, dev, iter(luts))

    def _visit(self, e: S.Expr, enc: EncodedBatch, dev, luts) -> torch.Tensor:
        if isinstance(e, S.BinaryOp):
            if e.op == "and":
                return self._visit(e.left, enc, dev, luts) & self._visit(e.right, enc, dev, luts)
            if e.op == "or":
                return self._visit(e.left, enc, dev, luts) | self._visit(e.right, enc, dev, luts)
            if e.op in ("=", "!=", "<", "<=", ">", ">="):
                return self._cmp(e, enc, dev, luts)
            if e.op in ("like", "ilike", "not_like", "not_ilike"):
                col = self._column_of(e.left, enc)
                if col.kind != "dict":
                    raise UnsupportedOnDevice("string predicate on non-string column")
                return kernels.lut_mask(dev[col.name], next(luts)) & dev[f"{col.name}__valid"]
        if isinstance(e, S.UnaryOp) and e.op == "not":
            return ~self._visit(e.operand, enc, dev, luts)
        if isinstance(e, S.Between):
            m = self._cmp(S.BinaryOp(">=", e.expr, e.low), enc, dev, luts) & self._cmp(
                S.BinaryOp("<=", e.expr, e.high), enc, dev, luts
            )
            return ~m if e.negated else m
        if isinstance(e, S.InList):
            return self._in_list(e, enc, dev, luts)
        if isinstance(e, S.IsNull):
            col = self._column_of(e.expr, enc)
            valid = dev[f"{col.name}__valid"]
            return valid if e.negated else ~valid
        if isinstance(e, S.FunctionCall) and e.name in ("regexp_match", "regexp_like"):
            col = self._column_of(e.args[0], enc)
            if col.kind != "dict":
                raise UnsupportedOnDevice("regex on non-string column")
            return kernels.lut_mask(dev[col.name], next(luts)) & dev[f"{col.name}__valid"]
        if isinstance(e, S.Literal) and isinstance(e.value, bool):
            return torch.full_like(dev["__ones"], e.value)
        raise UnsupportedOnDevice(f"predicate not device-mappable: {type(e).__name__}")

    # ---------------------------------------------------------- shared bits

    def _column_of(self, e: S.Expr, enc: EncodedBatch) -> EncodedColumn:
        if isinstance(e, S.Cast):
            return self._column_of(e.expr, enc)
        if not isinstance(e, S.Column):
            raise UnsupportedOnDevice("expected a column operand")
        col = enc.columns.get(e.name)
        if col is None:
            raise UnsupportedOnDevice(f"column {e.name} not encoded")
        return col

    def _literal_of(self, e: S.Expr) -> Any:
        if isinstance(e, S.Literal):
            return e.value
        if isinstance(e, S.Cast):
            return self._literal_of(e.expr)
        if isinstance(e, S.FunctionCall) and e.name == "to_timestamp" and e.args:
            return self._literal_of(e.args[0])
        raise UnsupportedOnDevice("expected a literal operand")

    def _cmp_parts(self, e: S.BinaryOp, enc: EncodedBatch):
        left_is_col = isinstance(e.left, (S.Column, S.Cast)) and not isinstance(e.left, S.Literal)
        if left_is_col:
            return self._column_of(e.left, enc), e.op, self._literal_of(e.right)
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        return self._column_of(e.right, enc), flip.get(e.op, e.op), self._literal_of(e.left)

    def _cmp(self, e: S.BinaryOp, enc: EncodedBatch, dev, luts) -> torch.Tensor:
        col, op, lit = self._cmp_parts(e, enc)
        valid = dev[f"{col.name}__valid"]
        values = dev[col.name]
        if col.kind == "dict":
            mask = kernels.lut_mask(values, next(luts))
        elif col.kind == "time":
            # values are exact int32 ms rel to the block origin, so every
            # comparison op (incl. sub-second literals) is exact
            mask = _num_cmp(values, op, next(luts))
        elif col.kind in ("num", "bool"):
            if not isinstance(lit, (int, float, bool)):
                raise UnsupportedOnDevice("numeric compared to non-numeric literal")
            mask = _num_cmp(values, op, _f32(lit))
        else:
            raise UnsupportedOnDevice(f"cannot compare column kind {col.kind}")
        return mask & valid

    @staticmethod
    def _time_lit(enc: EncodedBatch, op: str, lit: Any) -> int:
        """Literal as block-relative int ms. Sub-ms literals FLOOR to ms,
        matching the CPU engine's coercion; out-of-range literals clamp to
        just inside int32, so they compare uniformly against every row."""
        del op  # same floor for every comparison op (CPU-engine parity)
        if isinstance(lit, str):
            lit_dt = parse_rfc3339(lit)
        elif isinstance(lit, datetime):
            lit_dt = lit if lit.tzinfo else lit.replace(tzinfo=UTC)
        else:
            raise UnsupportedOnDevice("timestamp compared to non-time literal")
        rel = _dt_to_us(lit_dt) // 1000 - enc.time_origin_ms
        return max(-(2**31) + 2, min(2**31 - 2, rel))

    def _in_list(self, e: S.InList, enc: EncodedBatch, dev, luts) -> torch.Tensor:
        col = self._column_of(e.expr, enc)
        valid = dev[f"{col.name}__valid"]
        if col.kind == "dict":
            return kernels.lut_mask(dev[col.name], next(luts)) & valid
        if col.kind in ("num", "bool"):
            values = dev[col.name]
            mask = torch.zeros_like(valid)
            for item in e.items:
                mask = mask | (values == _f32(self._literal_of(item)))
            if e.negated:
                mask = ~mask
            return mask & valid
        raise UnsupportedOnDevice("IN on unsupported column kind")

    # ---------------------------------------------------------- LUT builders
    # LUTs are built over the BATCH dictionary (codes index it directly) and
    # cached on the EncodedBatch.

    @staticmethod
    def _batch_cache(enc: EncodedBatch) -> dict:
        cache = getattr(enc, "lut_cache", None)
        if cache is None:
            cache = {}
            enc.lut_cache = cache
        return cache

    def _padded(self, lut: np.ndarray) -> np.ndarray:
        n = _pow2(len(lut))
        if n == len(lut):
            return lut
        out = np.zeros(n, dtype=bool)
        out[: len(lut)] = lut
        return out

    def _dict_lut(self, enc: EncodedBatch, col: EncodedColumn, op: str, lit: Any) -> np.ndarray:
        cache = self._batch_cache(enc)
        key = (col.name, op, repr(lit))
        hit = cache.get(key)
        if hit is not None:
            return hit
        import operator as _op

        values = col.dictionary[:-1]
        fns = {"=": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge}
        f = fns[op]
        lut = np.zeros(len(values) + 1, dtype=bool)  # +1 null slot -> False
        for i, v in enumerate(values):
            if v is None:
                continue
            try:
                lut[i] = bool(f(v, lit))
            except TypeError:
                lut[i] = False
        lut = self._padded(lut)
        cache[key] = lut
        return lut

    def _regex_lut(
        self, enc: EncodedBatch, col: EncodedColumn, pattern: str, flags: int, negate: bool
    ) -> np.ndarray:
        if col.kind != "dict":
            raise UnsupportedOnDevice("string predicate on non-string column")
        cache = self._batch_cache(enc)
        key = (col.name, pattern, flags, negate)
        hit = cache.get(key)
        if hit is not None:
            return hit
        rx = re.compile(pattern, flags)
        values = col.dictionary[:-1]
        lut = np.zeros(len(values) + 1, dtype=bool)
        for i, v in enumerate(values):
            if isinstance(v, str):
                m = rx.search(v) is not None
                lut[i] = (not m) if negate else m
        lut = self._padded(lut)
        cache[key] = lut
        return lut

    def _in_lut(self, enc: EncodedBatch, e: S.InList, col: EncodedColumn) -> np.ndarray:
        cache = self._batch_cache(enc)
        lits = {self._literal_of(i) for i in e.items}
        key = (col.name, "in", repr(sorted(map(repr, lits))), e.negated)
        hit = cache.get(key)
        if hit is not None:
            return hit
        values = col.dictionary[:-1]
        lut = np.zeros(len(values) + 1, dtype=bool)
        for i, v in enumerate(values):
            inside = v in lits
            lut[i] = (not inside) if e.negated else inside
        lut = self._padded(lut)
        cache[key] = lut
        return lut


_EPOCH_UTC = datetime(1970, 1, 1, tzinfo=UTC)


def _dt_to_us(dt: datetime) -> int:
    """Exact integer epoch-microseconds (float .timestamp() wobbles at
    2024-era magnitudes; datetime precision is exactly us)."""
    return (dt - _EPOCH_UTC) // timedelta(microseconds=1)


def _f32(v: Any) -> float:
    """A numeric literal rounded to f32, so comparing it with f32 column
    values gives what the f32 compare of the JAX package gives."""
    return float(np.float32(float(v)))


def _num_cmp(values: torch.Tensor, op: str, threshold) -> torch.Tensor:
    return {
        "=": values == threshold,
        "!=": values != threshold,
        "<": values < threshold,
        "<=": values <= threshold,
        ">": values > threshold,
        ">=": values >= threshold,
    }[op]


# ------------------------------------------------------------ dense agg state


@dataclass(frozen=True)
class AccLayout:
    """Row arithmetic of the packed device accumulator (one f32 row each).

    Kernel stacking order, built from the AggSpec list once per query:

      sums:  [sum/avg cols]
      mins:  [min cols]
      maxs:  [max cols]
      valid: [sum/avg cols] [min cols] [max cols] [count(col) cols]

    Accumulator rows: [0] count(*) mask hits | [1, 1+n_allk) per-agg counts
    | n_sum sums | n_min mins | n_max maxs. The JAX layout's stddev/var,
    percentile and distinct sections are later work; those aggregates raise
    UnsupportedOnDevice here.
    """

    sum_idx: tuple[int, ...]  # spec indices: sum/avg
    min_idx: tuple[int, ...]
    max_idx: tuple[int, ...]
    countcol_idx: tuple[int, ...]

    @property
    def n_sum(self) -> int:
        return len(self.sum_idx)

    @property
    def n_mink(self) -> int:
        return len(self.min_idx)

    @property
    def n_maxk(self) -> int:
        return len(self.max_idx)

    @property
    def n_allk(self) -> int:  # validity / per-agg-count rows (kernel)
        return self.n_sum + self.n_mink + self.n_maxk + len(self.countcol_idx)

    @property
    def n_rows(self) -> int:  # total packed accumulator rows
        return 1 + self.n_allk + self.n_sum + self.n_mink + self.n_maxk

    def pac_row(self, si: int) -> int:
        """Per-agg non-null count row for spec `si`."""
        if si in self.sum_idx:
            return 1 + self.sum_idx.index(si)
        if si in self.min_idx:
            return 1 + self.n_sum + self.min_idx.index(si)
        if si in self.max_idx:
            return 1 + self.n_sum + self.n_mink + self.max_idx.index(si)
        return 1 + self.n_sum + self.n_mink + self.n_maxk + self.countcol_idx.index(si)

    def sum_row(self, si: int) -> int:
        return 1 + self.n_allk + self.sum_idx.index(si)

    def min_row(self, si: int) -> int:
        return 1 + self.n_allk + self.n_sum + self.min_idx.index(si)

    def max_row(self, si: int) -> int:
        return 1 + self.n_allk + self.n_sum + self.n_mink + self.max_idx.index(si)

    @classmethod
    def from_specs(cls, specs: list[AggSpec]) -> "AccLayout":
        """Classify specs into packed sections; raises UnsupportedOnDevice
        for aggregates this slice's device path does not express."""
        sections: dict[str, list[int]] = {"sum": [], "min": [], "max": [], "count": []}
        for i, spec in enumerate(specs):
            if spec.func == "count_star":
                continue
            if not isinstance(spec.arg, S.Column):
                raise UnsupportedOnDevice(f"aggregate over expression: {S.expr_name(spec.arg)}")
            section = "sum" if spec.func in ("sum", "avg") else spec.func
            if section not in sections:
                raise UnsupportedOnDevice(f"aggregate {spec.func}")
            sections[section].append(i)
        return cls(
            sum_idx=tuple(sections["sum"]),
            min_idx=tuple(sections["min"]),
            max_idx=tuple(sections["max"]),
            countcol_idx=tuple(sections["count"]),
        )


@dataclass
class PlanLayout:
    """Everything that shapes the device fold for one capacity epoch."""

    key_specs: list[KeySpec]
    sum_cols: list[str]
    min_cols: list[str]
    max_cols: list[str]
    cnt_cols: list[str]


def _kernel_stacks(dev: dict, layout: PlanLayout, local_rows: int, device: torch.device):
    """Build fused_groupby_block inputs per the AccLayout kernel stacking.
    Returns (sum_values, min_values, max_values, valid, n_sum, n_min, n_max),
    each tensor shaped [rows, local_rows]."""

    def stack(names: list[str], suffix: str = "", dtype=torch.float32) -> torch.Tensor:
        if not names:
            return torch.zeros((0, local_rows), dtype=dtype, device=device)
        return torch.stack([dev[n + suffix].to(dtype) for n in names])

    valid_cols = layout.sum_cols + layout.min_cols + layout.max_cols + layout.cnt_cols
    return (
        stack(layout.sum_cols),
        stack(layout.min_cols),
        stack(layout.max_cols),
        stack(valid_cols, "__valid", torch.bool),
        len(layout.sum_cols),
        len(layout.min_cols),
        len(layout.max_cols),
    )


# ---------------------------------------------------------------- transfer


def _transfer(
    enc: EncodedBatch, device: torch.device, aux: dict[str, np.ndarray], ones: torch.Tensor
) -> tuple[dict, int]:
    """Ship one encoded block plus its LUTs/remaps (`aux`) to `device`.

    Every buffer packs into ONE host payload (pinned when the target is a
    card) at 16-byte-aligned offsets, crosses in ONE non_blocking copy, and
    is carved back into typed tensors with `.view(dtype)`. Null-free
    columns share the device `ones` mask instead of shipping a validity
    array each — transfer bytes are the scan budget. Returns (tensors by
    name, bytes shipped)."""
    parts: list[tuple[str, np.ndarray]] = []
    for name, col in enc.columns.items():
        parts.append((name, col.values))
        if not col.all_valid:
            parts.append((f"{name}__valid", col.valid))
    if enc.num_rows != enc.block_rows:
        parts.append(("__rowmask", enc.row_mask))
    parts.extend(aux.items())

    offsets = []
    off = 0
    for _, arr in parts:
        offsets.append(off)
        off += -(-arr.nbytes // _ALIGN) * _ALIGN
    pinned = device.type == "cuda"
    host = torch.empty(off, dtype=torch.uint8, pin_memory=pinned)
    host_np = host.numpy()
    for (_, arr), o in zip(parts, offsets):
        host_np[o : o + arr.nbytes] = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    payload = host.to(device, non_blocking=pinned)

    dev: dict[str, torch.Tensor] = {}
    for (key, arr), o in zip(parts, offsets):
        seg = payload[o : o + arr.nbytes]
        dev[key] = seg.view(_TORCH_DTYPES[arr.dtype])
    for name, col in enc.columns.items():
        if col.all_valid:
            dev[f"{name}__valid"] = ones
    dev["__ones"] = ones
    return dev, off


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def _concat_tables(tables: list[pa.Table]) -> pa.Table:
    if len(tables) == 1:
        return tables[0]
    return pa.concat_tables(tables, promote_options="permissive")


# ---------------------------------------------------------------- executor


class GpuQueryExecutor(QueryExecutor):
    """Dense group-by aggregation on the card (or, for tests, on the CPU
    through the kernels' plain versions when `device="cpu"`)."""

    def __init__(
        self,
        plan: LogicalPlan,
        options: Options | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__(plan)
        self.options = options or Options()
        self.device = require_device(device)
        self._ones: dict[int, torch.Tensor] = {}
        # per-query route observability: how every scanned block was
        # dispatched, plus the transfer bytes each direction cost
        self.route_stats: dict[str, int] = {
            "device_cold": 0,  # encoded + shipped this query
            "cpu_fallback": 0,  # unsupported on device
            "h2d_bytes": 0,
            "d2h_bytes": 0,
        }
        # host wall ms per stage of the device path: host encode + LUTs
        # ("encode"), packing + the copy's enqueue ("transfer"), enqueue of
        # the fold's device work ("fold"), and the readback, which waits
        # for the device to finish, + finalize ("finalize")
        self.stage_ms: dict[str, float] = dict.fromkeys(
            ("encode", "transfer", "fold", "finalize"), 0.0
        )

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_ms[name] += (time.perf_counter() - t0) * 1000

    # ------------------------------------------------------------------ main

    def execute(self, tables: Iterator[pa.Table]) -> pa.Table:
        if self.plan.is_aggregate:
            try:
                return self._execute_aggregate_gpu(tables)
            except UnsupportedOnDevice as e:
                # plan-time rejection: the iterator is untouched
                logger.info("GPU path unsupported (%s); CPU engine", e)
                self.route_stats["cpu_fallback"] += 1
                return super()._execute_aggregate(tables)
        # plain SELECT (device WHERE mask + host filter) is later work
        self.route_stats["cpu_fallback"] += 1
        return super()._execute_select(tables)

    def _device_ones(self, block_rows: int) -> torch.Tensor:
        ones = self._ones.get(block_rows)
        if ones is None:
            ones = torch.ones(block_rows, dtype=torch.bool, device=self.device)
            self._ones[block_rows] = ones
        return ones

    def _readback(self, x: torch.Tensor) -> np.ndarray:
        """Device -> host f64 readback, priced into route_stats."""
        self.route_stats["d2h_bytes"] += x.numel() * x.element_size()
        return x.cpu().numpy().astype(np.float64)

    # -------------------------------------------------------------- aggregate

    def _execute_aggregate_gpu(self, tables: Iterator[pa.Table]) -> pa.Table:
        sel = self.plan.select
        agg, rewritten, group_names = self.build_aggregator()
        specs = agg.specs

        key_specs = [classify_group_expr(g) for g in sel.group_by]
        lay = AccLayout.from_specs(specs)
        layout = PlanLayout(
            key_specs=key_specs,
            sum_cols=[specs[i].arg.name for i in lay.sum_idx],
            min_cols=[specs[i].arg.name for i in lay.min_idx],
            max_cols=[specs[i].arg.name for i in lay.max_idx],
            cnt_cols=[specs[i].arg.name for i in lay.countcol_idx],
        )
        numeric_idx = set(lay.sum_idx + lay.min_idx + lay.max_idx)
        compiler = PredicateCompiler()
        dict_cols = {ks.column for ks in key_specs if ks.kind == "dict"}
        needed = self.plan.needed_columns
        bounds_ms = self._bounds_ms()

        acc: torch.Tensor | None = None  # device-resident packed accumulator (R, G)
        acc_groups = 0

        def new_acc(num_groups: int) -> torch.Tensor:
            """Packed accumulator rows (AccLayout): count | per-agg counts |
            sums | mins | maxs."""
            a = torch.zeros((lay.n_rows, num_groups), dtype=torch.float32, device=self.device)
            lo = 1 + lay.n_allk + lay.n_sum
            a[lo : lo + lay.n_mink] = kernels.F32_MAX
            a[lo + lay.n_mink :] = -kernels.F32_MAX
            return a

        force_cpu_rest = False
        for table in self._blocks(tables):
            self._check_deadline()
            try:
                if force_cpu_rest:
                    raise UnsupportedOnDevice("group space beyond the dense device budget")
                with self._stage("encode"):
                    enc = encode_table(table, needed, dict_columns=dict_cols)
                if enc is None:
                    raise UnsupportedOnDevice("unencodable column in batch")
                for i in numeric_idx | set(lay.countcol_idx):
                    col = enc.columns.get(specs[i].arg.name)
                    if col is None:
                        raise UnsupportedOnDevice(f"aggregate column {specs[i].arg.name} missing")
                    if col.kind in ("dict", "time") and i in numeric_idx:
                        raise UnsupportedOnDevice(f"numeric aggregate over {col.kind} column")
                with self._stage("encode"):
                    luts = compiler.collect_luts(sel.where, enc)
                    remaps = []
                    for ks in key_specs:
                        if ks.kind != "dict":
                            continue
                        if ks.column not in enc.columns:
                            raise UnsupportedOnDevice("group key column missing from batch")
                        remaps.append(ks.gdict.absorb(enc.columns[ks.column].dictionary))
                layouts = [self._required_layout(ks, enc) for ks in key_specs]
                new_groups = max(int(np.prod([c for _, c in layouts])), 1)
                if new_groups > DENSE_G_MAX:
                    # caps only grow, so no later block fits either: the
                    # rest of the scan aggregates on the host
                    force_cpu_rest = True
                    raise UnsupportedOnDevice(f"group space {new_groups} > {DENSE_G_MAX}")
                current = tuple((ks.origin_rel or 0, ks.capacity) for ks in key_specs)
                if acc is None or tuple(layouts) != current:
                    # new capacity epoch: fold the old accumulator into the
                    # host aggregator under the old layout, then resize
                    if acc is not None:
                        self._flush_state(self._readback(acc), key_specs, agg, specs, lay)
                    for ks, (o, c) in zip(key_specs, layouts):
                        ks.capacity = c
                        ks.origin_rel = o if ks.kind == "timebin" else None
                    acc_groups = new_groups
                    acc = new_acc(acc_groups)
                time_args = self._time_args(enc, key_specs, bounds_ms)
                aux = {f"__lut{i}": l for i, l in enumerate(luts) if isinstance(l, np.ndarray)}
                aux.update({f"__remap{i}": r for i, r in enumerate(remaps)})
                with self._stage("transfer"):
                    dev, nbytes = _transfer(
                        enc, self.device, aux, self._device_ones(enc.block_rows)
                    )
                self.route_stats["device_cold"] += 1
                self.route_stats["h2d_bytes"] += nbytes
                dev_luts = [
                    dev[f"__lut{i}"] if isinstance(l, np.ndarray) else l for i, l in enumerate(luts)
                ]
                dev_remaps = [dev[f"__remap{i}"] for i in range(len(remaps))]
                with self._stage("fold"):
                    self._fold_one(
                        acc, enc, dev, dev_luts, dev_remaps, time_args, layout, acc_groups,
                        bounds_ms, compiler,
                    )
            except UnsupportedOnDevice as e:
                logger.debug("batch on CPU (%s)", e)
                self.route_stats["cpu_fallback"] += 1
                t = self._bounds_filter(table)
                agg.update(t, self._where_mask(t))

        with self._stage("finalize"):
            if acc is not None and not agg.groups:
                # the run stayed on the device: vectorized dense finalize,
                # one readback, no per-group Python
                interim = self._dense_interim(self._readback(acc), key_specs, specs, lay)
                if interim.num_rows or sel.group_by:
                    return self.finalize_from_interim(interim, rewritten)
            elif acc is not None:
                self._flush_state(self._readback(acc), key_specs, agg, specs, lay)
            return self.finalize_aggregate(agg, rewritten, group_names)

    def _blocks(self, tables: Iterator[pa.Table]) -> Iterator[pa.Table]:
        """Coalesce small scan tables into larger device blocks (fewer
        launches per row); a table carrying a source id (one Parquet file)
        stays a block of its own, and oversized tables split."""
        target_rows = max(1 << 16, self.options.device_block_rows)
        buf: list[pa.Table] = []
        rows = 0
        for t in tables:
            if t.num_rows > MAX_BLOCK_ROWS:
                if buf:
                    yield _concat_tables(buf)
                    buf, rows = [], 0
                bare = t.replace_schema_metadata(None)
                for off in range(0, t.num_rows, MAX_BLOCK_ROWS):
                    yield bare.slice(off, MAX_BLOCK_ROWS)
                continue
            if (t.schema.metadata or {}).get(SOURCE_ID_META) is not None:
                yield t
                continue
            buf.append(t)
            rows += t.num_rows
            if rows >= target_rows:
                yield _concat_tables(buf)
                buf, rows = [], 0
        if buf:
            yield _concat_tables(buf)

    def _fold_one(
        self,
        acc: torch.Tensor,
        enc: EncodedBatch,
        dev: dict,
        luts: list,
        remaps: list,
        time_args: list[int],
        layout: PlanLayout,
        num_groups: int,
        bounds_ms: tuple[int | None, int | None],
        compiler: PredicateCompiler,
    ) -> None:
        """Mask + group ids + fused partial aggregate for one block, folded
        into `acc` IN PLACE (add for the additive rows, min/max for the
        rest) — the accumulator is owned by this query alone."""
        rows = enc.block_rows
        mask = compiler.trace(self.plan.select.where, enc, dev, luts)
        mask = mask & dev.get("__rowmask", dev["__ones"])
        n_timebin = sum(1 for ks in layout.key_specs if ks.kind == "timebin")
        if any(b is not None for b in bounds_ms) and DEFAULT_TIMESTAMP_KEY in enc.columns:
            ts = dev[DEFAULT_TIMESTAMP_KEY]
            bi = 2 * n_timebin
            if bounds_ms[0] is not None:
                mask = mask & (ts >= time_args[bi])
                bi += 1
            if bounds_ms[1] is not None:
                mask = mask & (ts < time_args[bi])
            mask = mask & dev[f"{DEFAULT_TIMESTAMP_KEY}__valid"]

        ids = torch.zeros(rows, dtype=torch.int32, device=self.device)
        stride = 1
        ri = ti = 0
        for ks in layout.key_specs:
            cap = ks.capacity
            if ks.kind == "dict":
                codes = torch.clamp(kernels.lut_mask(dev[ks.column], remaps[ri]), max=cap - 1)
                ri += 1
            else:
                shift, k_off = time_args[ti], time_args[ti + 1]
                ti += 2
                # floor division, as jnp's // on int32 (negative offsets)
                binned = torch.div(dev[ks.column] + shift, ks.bin_ms, rounding_mode="floor")
                codes = torch.clamp(binned + k_off, 0, cap - 1)
            ids += codes.to(torch.int32) * stride
            stride *= cap

        sum_v, min_v, max_v, valid_v, n_sum, n_min, n_max = _kernel_stacks(
            dev, layout, rows, self.device
        )
        count, pac, sums, mins, maxs = kernels.fused_groupby_block(
            ids, mask, sum_v, min_v, max_v, valid_v, num_groups, n_sum, n_min, n_max
        )
        a0 = 1 + pac.shape[0] + sums.shape[0]
        acc[0] += count
        acc[1:a0] += torch.cat([pac, sums], dim=0)
        acc[a0 : a0 + n_min] = torch.minimum(acc[a0 : a0 + n_min], mins)
        acc[a0 + n_min :] = torch.maximum(acc[a0 + n_min :], maxs)

    # ------------------------------------------------------------- internals

    def _bounds_ms(self) -> tuple[int | None, int | None]:
        """API time bounds as absolute epoch ms, FLOORED for sub-ms bounds,
        as the CPU engine's _bounds_filter coerces them."""
        tb = self.plan.time_bounds
        out = []
        for b in (tb.low, tb.high):
            if b is None:
                out.append(None)
                continue
            bb = b if b.tzinfo else b.replace(tzinfo=UTC)
            out.append(_dt_to_us(bb) // 1000)
        return tuple(out)

    @staticmethod
    def _time_args(
        enc: EncodedBatch,
        key_specs: list[KeySpec],
        bounds_ms: tuple[int | None, int | None],
    ) -> list[int]:
        """Per-block time scalars: [per-timebin-key (shift, K)..., bounds
        lo?, bounds hi?].

        shift = origin % bin (so (rel + shift) // bin is the global bin
        index minus origin//bin) and K = origin//bin - scan_lo_bin (the
        block's bin offset inside the scan's group window). Bounds clamp
        like predicate literals."""
        out: list[int] = []
        for ks in key_specs:
            if ks.kind != "timebin":
                continue
            shift = enc.time_origin_ms % ks.bin_ms
            k_off = enc.time_origin_ms // ks.bin_ms - int(ks.origin_rel or 0)
            if not (-(2**31) < k_off < 2**31):
                raise UnsupportedOnDevice("block outside the scan's bin window")
            out.extend((shift, k_off))
        for b in bounds_ms:
            if b is not None:
                rel = b - enc.time_origin_ms
                out.append(max(-(2**31) + 2, min(2**31 - 2, rel)))
        return out

    def _required_layout(self, ks: KeySpec, enc: EncodedBatch) -> tuple[int, int]:
        """(origin, capacity) this key needs for the incoming batch. A change
        in either forces a dense-state flush before processing the batch."""
        if ks.kind == "dict":
            card = max(1, len(ks.gdict) + 1)  # +1 null slot
            cap = max(ks.capacity, 2)
            while cap < card:
                cap *= 2
            return 0, cap
        col = enc.columns.get(ks.column)
        if col is None:
            raise UnsupportedOnDevice(f"time column {ks.column} missing")
        if col.vmin is None or col.vmax is None:
            return ks.origin_rel or 0, max(ks.capacity, 2)
        lo_bin = (enc.time_origin_ms + col.vmin) // ks.bin_ms
        hi_bin = (enc.time_origin_ms + col.vmax) // ks.bin_ms
        if ks.origin_rel is None and self.plan.scan_time_hint is not None:
            # pre-size from the scan's manifest time range: one capacity
            # epoch, one flush, one readback for the whole query
            h_lo, h_hi = self.plan.scan_time_hint
            hint_lo_bin = int(h_lo.timestamp() * 1000) // ks.bin_ms
            hint_hi_bin = int(h_hi.timestamp() * 1000) // ks.bin_ms
            if 0 < hint_hi_bin - hint_lo_bin <= (1 << 22):
                lo_bin = min(lo_bin, hint_lo_bin)
                hi_bin = max(hi_bin, hint_hi_bin)
        origin_bin = lo_bin if ks.origin_rel is None else min(ks.origin_rel, lo_bin)
        span = hi_bin - origin_bin + 1
        cap = max(ks.capacity, 2)
        while cap < span:
            cap *= 2
        if cap > (1 << 22):
            raise UnsupportedOnDevice(
                f"time-bin span {span} exceeds device group capacity; widen the bin"
            )
        return origin_bin, cap

    def _dense_interim(
        self,
        arr: np.ndarray,
        key_specs: list[KeySpec],
        specs: list[AggSpec],
        lay: AccLayout,
    ) -> pa.Table:
        """Dense accumulator readback -> interim table (__g/__agg columns),
        vectorized: key decode by divmod over capacities, aggregate finalize
        by numpy masking."""
        count = arr[0]
        idxs = np.nonzero(count > 0)[0]
        cols: dict[str, pa.Array] = {}
        rem = idxs.copy()
        for i, ks in enumerate(key_specs):
            codes = rem % ks.capacity
            rem = rem // ks.capacity
            if ks.kind == "dict":
                gd = ks.gdict
                values = np.empty(len(gd) + 1, dtype=object)
                values[:-1] = gd.values
                values[-1] = None  # null / overflow slot
                cols[f"__g{i}"] = pa.array(values[np.minimum(codes, len(gd))].tolist())
            else:
                abs_ms = ((ks.origin_rel or 0) + codes) * ks.bin_ms
                cols[f"__g{i}"] = pa.array(abs_ms.astype("datetime64[ms]"), pa.timestamp("ms"))
        for si, spec in enumerate(specs):
            if spec.func == "count_star":
                cols[f"__agg{si}"] = pa.array(count[idxs].astype(np.int64))
                continue
            pac = arr[lay.pac_row(si)][idxs]
            seen = pac > 0
            if spec.func == "count":
                cols[f"__agg{si}"] = pa.array(pac.astype(np.int64))
            elif spec.func in ("sum", "avg"):
                v = arr[lay.sum_row(si)][idxs]
                if spec.func == "avg":
                    v = np.divide(v, pac, out=np.zeros_like(v), where=seen)
                cols[f"__agg{si}"] = pa.array(v, mask=~seen)
            elif spec.func == "min":
                cols[f"__agg{si}"] = pa.array(arr[lay.min_row(si)][idxs], mask=~seen)
            elif spec.func == "max":
                cols[f"__agg{si}"] = pa.array(arr[lay.max_row(si)][idxs], mask=~seen)
        if not cols:
            return pa.table({"__dummy": pa.array([None] * len(idxs))})
        return pa.table(cols)

    def _flush_state(
        self,
        arr: np.ndarray,
        key_specs: list[KeySpec],
        agg: HashAggregator,
        specs: list[AggSpec],
        lay: AccLayout,
    ) -> None:
        """Dense accumulator readback -> sparse host aggregator, decoding
        group ids (a capacity epoch ended, or CPU-fallback blocks share the
        query)."""
        for flat in np.nonzero(arr[0] > 0)[0]:
            key_parts = []
            rem = int(flat)
            for ks in key_specs:
                code = rem % ks.capacity
                rem //= ks.capacity
                if ks.kind == "dict":
                    gd = ks.gdict
                    key_parts.append(gd.values[code] if code < len(gd) else None)
                else:
                    abs_ms = ((ks.origin_rel or 0) + code) * ks.bin_ms
                    key_parts.append(
                        datetime.fromtimestamp(abs_ms / 1000.0, UTC).replace(tzinfo=None)
                    )
            counts, sums_l, mins_l, maxs_l = [], [], [], []
            for si, spec in enumerate(specs):
                if spec.func == "count_star":
                    counts.append(int(arr[0][flat]))
                else:
                    counts.append(int(arr[lay.pac_row(si)][flat]))
                seen = spec.func != "count_star" and arr[lay.pac_row(si)][flat] > 0
                sums_l.append(
                    float(arr[lay.sum_row(si)][flat]) if spec.func in ("sum", "avg") else 0.0
                )
                # unseen = per-agg count 0 (the sentinel is f32 3.4e38, not
                # inf, so gate on the count instead of the value)
                mins_l.append(
                    float(arr[lay.min_row(si)][flat]) if spec.func == "min" and seen else None
                )
                maxs_l.append(
                    float(arr[lay.max_row(si)][flat]) if spec.func == "max" and seen else None
                )
            agg.merge_raw(tuple(key_parts), counts, sums_l, mins_l, maxs_l)
