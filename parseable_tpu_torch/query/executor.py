"""CPU query executor over pyarrow.compute — the oracle engine.

Counterpart of `parseable_tpu/query/executor.py`. Scans produce tables, each
table folds into a hash aggregate, and a finalize step evaluates the select
list, HAVING, ORDER BY and LIMIT. The GPU engine (`executor_cuda.py`)
subclasses it: device kernels produce the partials, and the host finalize
and `_order_limit` stay shared.

A GROUP BY whose aggregates all have a partial form (count, sum, avg,
min, max, stddev, var) runs two-phase, as the JAX engine does
(`parseable_tpu/query/executor.py:1184-1220`): each block folds into a
partial table through one pyarrow group_by, and ONE vectorized merge
(`query/partials.py`) follows, so a 1M-group query has no per-group Python.
Every other aggregate keeps the classic per-block hash aggregate, with the
same sketches as the JAX engine: approximate percentiles in a
`QuantileSketch` per group (`query/sketch.py`, exact below 1024 values)
and approx_distinct in HLL registers (`ops/hll_sketch.py`). Window
functions are later work and raise ExecError here.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from datetime import UTC, datetime, timedelta
from typing import Any, Iterator

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from parseable_tpu_torch.ops.hll_sketch import estimate, merge_registers, registers_add
from parseable_tpu_torch.ops.link import get_link
from parseable_tpu_torch.query import partials as PT
from parseable_tpu_torch.query import sql as S
from parseable_tpu_torch.query.partials import (
    _combine_codes,
    _encode_key,
    _FastPathUnavailable,
    decode_dictionary_columns,
)
from parseable_tpu_torch.query.sketch import QuantileSketch
from parseable_tpu_torch.query.planner import LogicalPlan
from parseable_tpu_torch.utils.timeutil import parse_duration, parse_rfc3339, time_ticks

class ExecError(ValueError):
    pass


class QueryTimeout(ExecError):
    """Cooperative SQL timeout (reference: QUERY_RUNTIME sql timeout,
    src/query/mod.rs:92,152-165). Raised between scan blocks once the
    plan's deadline passes."""


class MemoryLimitExceeded(ExecError):
    """Result materialization exceeded the query memory cap (reference:
    85% memory pool / P_QUERY_MEMORY_LIMIT, src/query/mod.rs:216-226)."""


# ------------------------------------------------------------- expression eval


def _interval_to_timedelta(text: str) -> timedelta:
    return parse_duration(text)


def evaluate(e: S.Expr, table: pa.Table) -> Any:
    """Evaluate a scalar (non-aggregate) expression -> Array or python scalar."""
    if isinstance(e, S.Literal):
        return e.value
    if isinstance(e, S.Column):
        # qualified refs resolve against join-output columns ("alias.col")
        if e.table is not None and f"{e.table}.{e.name}" in table.column_names:
            return table.column(f"{e.table}.{e.name}").combine_chunks()
        if e.name not in table.column_names:
            return pa.nulls(table.num_rows)
        return table.column(e.name).combine_chunks()
    if isinstance(e, S.Star):
        raise ExecError("'*' outside count()")
    if isinstance(e, S.IntervalLit):
        return _interval_to_timedelta(e.text)
    if isinstance(e, S.UnaryOp):
        v = evaluate(e.operand, table)
        if e.op == "-":
            return pc.negate(_arr(v, table)) if _is_arr(v) else -v
        if e.op == "not":
            return pc.invert(_arr(v, table))
        raise ExecError(f"unknown unary op {e.op}")
    if isinstance(e, S.BinaryOp):
        return _eval_binary(e, table)
    if isinstance(e, S.InList):
        arr = _arr(evaluate(e.expr, table), table)
        values = [i.value if isinstance(i, S.Literal) else evaluate(i, table) for i in e.items]
        mask = pc.is_in(arr, value_set=pa.array(values))
        # pc.is_in answers false for a NULL input; in SQL it is NULL, and so
        # is its negation (NOT IN drops the row)
        mask = pc.if_else(pc.is_valid(arr), mask, pa.scalar(None, pa.bool_()))
        return pc.invert(mask) if e.negated else mask
    if isinstance(e, S.Between):
        arr = _arr(evaluate(e.expr, table), table)
        lo = _coerce_scalar(evaluate(e.low, table), arr.type, ">=")
        hi = _coerce_scalar(evaluate(e.high, table), arr.type, "<=")
        mask = pc.and_(pc.greater_equal(arr, lo), pc.less_equal(arr, hi))
        return pc.invert(mask) if e.negated else mask
    if isinstance(e, S.IsNull):
        arr = _arr(evaluate(e.expr, table), table)
        return pc.is_valid(arr) if e.negated else pc.is_null(arr)
    if isinstance(e, S.Cast):
        return _eval_cast(e, table)
    if isinstance(e, S.Case):
        return _eval_case(e, table)
    if isinstance(e, S.FunctionCall):
        return _eval_function(e, table)
    raise ExecError(f"cannot evaluate {e!r}")


def _is_arr(v: Any) -> bool:
    return isinstance(v, (pa.Array, pa.ChunkedArray))


def _arr(v: Any, table: pa.Table) -> pa.Array:
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    if isinstance(v, pa.Array):
        return v
    return pa.array([v] * table.num_rows)


# `_coerce_scalar`'s answer for a time literal that falls between two ticks
# of the column under = or !=
_BETWEEN_TICKS = object()
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _coerce_scalar(v: Any, t: pa.DataType, op: str) -> Any:
    """A literal for `array op v` over an array of type `t`: a time literal
    becomes a scalar of the array's unit, rounded up for >= and < and down
    otherwise, so that the comparison stays exact (a sub-ms bound keeps the
    row stamped in its millisecond); `_BETWEEN_TICKS` for = and != when no
    value of the unit equals it."""
    if pa.types.is_timestamp(t) and isinstance(v, (str, datetime)):
        ticks = time_ticks(parse_rfc3339(v) if isinstance(v, str) else v, t.unit, op)
        return _BETWEEN_TICKS if ticks is None else pa.scalar(ticks, type=t)
    return v


def time_bounds_mask(col: pa.ChunkedArray | pa.Array, low: datetime | None,
                     high: datetime | None) -> pa.ChunkedArray | pa.Array | None:
    """col >= low AND col < high over a timestamp column (None for no
    bound), the bounds rounded up to the column's unit."""
    mask = None
    if low is not None:
        mask = pc.greater_equal(col, _coerce_scalar(low, col.type, ">="))
    if high is not None:
        m2 = pc.less(col, _coerce_scalar(high, col.type, "<"))
        mask = m2 if mask is None else pc.and_(mask, m2)
    return mask


def _eval_binary(e: S.BinaryOp, table: pa.Table) -> Any:
    op = e.op
    if op in ("and", "or"):
        l = _arr(evaluate(e.left, table), table)
        r = _arr(evaluate(e.right, table), table)
        return pc.and_kleene(l, r) if op == "and" else pc.or_kleene(l, r)
    if op in ("like", "ilike", "not_like", "not_ilike"):
        arr = _arr(evaluate(e.left, table), table)
        pattern = evaluate(e.right, table)
        if not isinstance(pattern, str):
            raise ExecError("LIKE pattern must be a string literal")
        mask = pc.match_like(arr, pattern, ignore_case="ilike" in op)
        return pc.invert(mask) if op.startswith("not_") else mask
    if op == "||":
        l = _arr(evaluate(e.left, table), table)
        r = _arr(evaluate(e.right, table), table)
        return pc.binary_join_element_wise(pc.cast(l, pa.string()), pc.cast(r, pa.string()), "")

    lv = evaluate(e.left, table)
    rv = evaluate(e.right, table)
    # timestamp +/- interval
    if isinstance(rv, timedelta) and op in ("+", "-"):
        arr = _arr(lv, table)
        delta = pa.scalar(rv, type=pa.duration("ms"))
        return pc.add(arr, delta) if op == "+" else pc.subtract(arr, delta)
    larr = _is_arr(lv)
    rarr = _is_arr(rv)
    if not larr and not rarr:
        return _python_binop(op, lv, rv)
    a = _arr(lv, table) if larr else lv
    b = _arr(rv, table) if rarr else rv
    # coerce scalar side for timestamp comparisons
    if larr and not rarr:
        b = _coerce_scalar(b, a.type, op)
    if rarr and not larr:
        a = _coerce_scalar(a, b.type, _FLIP.get(op, op))
    if a is _BETWEEN_TICKS or b is _BETWEEN_TICKS:
        # no time value equals the literal: = is false, != true (NULL stays NULL)
        arr = a if larr else b
        return pc.not_equal(arr, arr) if op == "=" else pc.equal(arr, arr)
    fns = {
        "+": pc.add,
        "-": pc.subtract,
        "*": pc.multiply,
        "/": pc.divide,
        "%": lambda x, y: pc.subtract(x, pc.multiply(pc.floor(pc.divide(x, y)), y)),
        "=": pc.equal,
        "!=": pc.not_equal,
        "<": pc.less,
        "<=": pc.less_equal,
        ">": pc.greater,
        ">=": pc.greater_equal,
    }
    if op not in fns:
        raise ExecError(f"unknown operator {op}")
    return fns[op](a, b)


def _python_binop(op: str, a: Any, b: Any) -> Any:
    import operator

    fns = {
        "+": operator.add, "-": operator.sub, "*": operator.mul,
        "/": operator.truediv, "%": operator.mod, "=": operator.eq,
        "!=": operator.ne, "<": operator.lt, "<=": operator.le,
        ">": operator.gt, ">=": operator.ge,
    }
    return fns[op](a, b)


_CAST_TYPES = {
    "int": pa.int64(), "integer": pa.int64(), "bigint": pa.int64(),
    "float": pa.float64(), "double": pa.float64(), "real": pa.float64(),
    "text": pa.string(), "varchar": pa.string(), "string": pa.string(),
    "bool": pa.bool_(), "boolean": pa.bool_(),
    "timestamp": pa.timestamp("ms"), "date": pa.date32(),
}


def _eval_cast(e: S.Cast, table: pa.Table) -> Any:
    v = evaluate(e.expr, table)
    t = _CAST_TYPES.get(e.type_name)
    if t is None:
        raise ExecError(f"unknown cast type {e.type_name}")
    if _is_arr(v):
        return pc.cast(_arr(v, table), t, safe=False)
    return pa.scalar(v, type=t).as_py() if v is not None else None


def _eval_case(e: S.Case, table: pa.Table) -> Any:
    result = None
    if e.else_expr is not None:
        result = _arr(evaluate(e.else_expr, table), table)
    for cond, then in reversed(e.whens):
        mask = _arr(evaluate(cond, table), table)
        then_v = _arr(evaluate(then, table), table)
        if result is None:
            result = pc.if_else(mask, then_v, pa.nulls(table.num_rows, then_v.type))
        else:
            result = pc.if_else(mask, then_v, result)
    return result


def date_bin(interval: timedelta, arr: pa.Array, origin: datetime | None = None) -> pa.Array:
    """Floor timestamps to interval buckets (DataFusion date_bin parity)."""
    step_ms = int(interval.total_seconds() * 1000)
    if step_ms <= 0:
        raise ExecError("date_bin interval must be positive")
    origin_ms = int(origin.timestamp() * 1000) if origin else 0
    ints = pc.cast(arr, pa.int64())
    binned = pc.add(
        pc.multiply(
            pc.floor(pc.divide(pc.cast(pc.subtract(ints, origin_ms), pa.float64()), step_ms)),
            float(step_ms),
        ),
        float(origin_ms),
    )
    return pc.cast(pc.cast(binned, pa.int64()), arr.type)


def _eval_function(e: S.FunctionCall, table: pa.Table) -> Any:
    name = e.name
    if name == "date_bin":
        if len(e.args) < 2:
            raise ExecError("date_bin(interval, column[, origin])")
        interval = evaluate(e.args[0], table)
        if not isinstance(interval, timedelta):
            interval = _interval_to_timedelta(str(interval))
        arr = _arr(evaluate(e.args[1], table), table)
        origin = None
        if len(e.args) > 2:
            o = evaluate(e.args[2], table)
            if isinstance(o, str):
                    origin = parse_rfc3339(o)
        return date_bin(interval, arr, origin)
    if name == "date_trunc":
        if len(e.args) != 2:
            raise ExecError("date_trunc(unit, column)")
        unit = evaluate(e.args[0], table)
        arr = _arr(evaluate(e.args[1], table), table)
        return pc.floor_temporal(arr, unit=str(unit).lower())
    if name == "to_timestamp" or name == "to_timestamp_millis":
        v = evaluate(e.args[0], table)
        if _is_arr(v):
            return pc.cast(_arr(v, table), pa.timestamp("ms"), safe=False)
        return parse_rfc3339(v).replace(tzinfo=None) if isinstance(v, str) else v
    if name in ("lower", "upper", "length", "abs", "floor", "ceil", "trim"):
        arr = _arr(evaluate(e.args[0], table), table)
        fn = {
            "lower": pc.utf8_lower, "upper": pc.utf8_upper,
            "length": pc.utf8_length, "abs": pc.abs, "floor": pc.floor,
            "ceil": pc.ceil, "trim": pc.utf8_trim_whitespace,
        }[name]
        return fn(arr)
    if name == "round":
        arr = _arr(evaluate(e.args[0], table), table)
        digits = evaluate(e.args[1], table) if len(e.args) > 1 else 0
        return pc.round(arr, ndigits=int(digits))
    if name == "coalesce":
        args = [_arr(evaluate(a, table), table) for a in e.args]
        out = args[0]
        for nxt in args[1:]:
            out = pc.if_else(pc.is_valid(out), out, nxt)
        return out
    if name == "now":
        return datetime.now(UTC).replace(tzinfo=None)
    if name in ("regexp_match", "regexp_like"):
        arr = _arr(evaluate(e.args[0], table), table)
        pattern = evaluate(e.args[1], table)
        return pc.match_substring_regex(arr, str(pattern))
    if name == "strpos":
        arr = _arr(evaluate(e.args[0], table), table)
        sub = evaluate(e.args[1], table)
        return pc.add(pc.find_substring(arr, str(sub)), 1)
    # --- DataFusion-parity scalar surface (dashboards/alerts use these;
    # the reference gets them from DataFusion's function library) ---------
    if name in ("substr", "substring"):
        arr = _arr(evaluate(e.args[0], table), table)
        start = int(evaluate(e.args[1], table)) - 1  # SQL is 1-based
        if len(e.args) > 2:
            length = int(evaluate(e.args[2], table))
            return pc.utf8_slice_codeunits(arr, max(start, 0), max(start, 0) + length)
        return pc.utf8_slice_codeunits(arr, max(start, 0))
    if name == "replace":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.replace_substring(
            arr, str(evaluate(e.args[1], table)), str(evaluate(e.args[2], table))
        )
    if name == "concat":
        parts = [
            pc.cast(_arr(evaluate(a, table), table), pa.string()) for a in e.args
        ]
        # SQL concat skips NULLs (unlike ||): substitute empty strings
        parts = [pc.fill_null(x, "") for x in parts]
        return pc.binary_join_element_wise(*parts, "")
    if name == "concat_ws":
        sep = str(evaluate(e.args[0], table))
        parts = [
            pc.fill_null(pc.cast(_arr(evaluate(a, table), table), pa.string()), "")
            for a in e.args[1:]
        ]
        return pc.binary_join_element_wise(*parts, sep)
    if name == "split_part":
        import numpy as np

        arr = _arr(evaluate(e.args[0], table), table)
        sep = str(evaluate(e.args[1], table))
        idx = int(evaluate(e.args[2], table))
        # SQL split_part returns '' past the last part (list_element would
        # raise); slice the wanted element per row via list offsets
        split = pc.list_slice(pc.split_pattern(arr, sep), start=idx - 1, stop=idx)
        if isinstance(split, pa.ChunkedArray):
            split = split.combine_chunks()
        offsets = np.asarray(split.offsets)
        lens = np.diff(offsets)
        flat = split.flatten()
        take = np.where(lens > 0, offsets[:-1], 0)
        vals = flat.take(pa.array(np.clip(take, 0, max(len(flat) - 1, 0))))
        nulls = pc.is_null(arr).to_numpy(zero_copy_only=False)
        out = pc.if_else(pa.array(lens > 0), vals, pa.scalar("", pa.string()))
        return pc.if_else(pa.array(~nulls), out, pa.scalar(None, pa.string()))
    if name in ("extract", "date_part"):
        unit = str(evaluate(e.args[0], table)).lower()
        arr = _arr(evaluate(e.args[1], table), table)
        fns = {
            "year": pc.year, "month": pc.month, "day": pc.day,
            "hour": pc.hour, "minute": pc.minute, "second": pc.second,
            "dow": pc.day_of_week, "doy": pc.day_of_year,
            "week": pc.iso_week, "quarter": pc.quarter,
            "millisecond": pc.millisecond,
        }
        if unit not in fns:
            raise ExecError(f"unknown {name} unit {unit!r}")
        return pc.cast(fns[unit](arr), pa.int64())
    if name in ("char_length", "character_length"):
        return pc.utf8_length(_arr(evaluate(e.args[0], table), table))
    if name == "ltrim":
        return pc.utf8_ltrim_whitespace(_arr(evaluate(e.args[0], table), table))
    if name == "rtrim":
        return pc.utf8_rtrim_whitespace(_arr(evaluate(e.args[0], table), table))
    if name == "left":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.utf8_slice_codeunits(arr, 0, int(evaluate(e.args[1], table)))
    if name == "right":
        arr = _arr(evaluate(e.args[0], table), table)
        k = int(evaluate(e.args[1], table))
        # the slice kernel wants scalar offsets; reverse+left+reverse gives
        # per-row tails in three vectorized kernels
        rev = pc.utf8_reverse(arr)
        return pc.utf8_reverse(pc.utf8_slice_codeunits(rev, 0, k))
    if name == "repeat":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.binary_repeat(arr, int(evaluate(e.args[1], table)))
    if name == "reverse":
        return pc.utf8_reverse(_arr(evaluate(e.args[0], table), table))
    if name in ("lpad", "rpad"):
        arr = _arr(evaluate(e.args[0], table), table)
        width = int(evaluate(e.args[1], table))
        padchar = str(evaluate(e.args[2], table)) if len(e.args) > 2 else " "
        fn = pc.utf8_lpad if name == "lpad" else pc.utf8_rpad
        return fn(arr, width, padding=padchar)
    if name == "starts_with":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.starts_with(arr, str(evaluate(e.args[1], table)))
    if name == "ends_with":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.ends_with(arr, str(evaluate(e.args[1], table)))
    if name == "contains":
        arr = _arr(evaluate(e.args[0], table), table)
        return pc.match_substring(arr, str(evaluate(e.args[1], table)))
    if name == "nullif":
        a = _arr(evaluate(e.args[0], table), table)
        b = evaluate(e.args[1], table)
        b_arr = _arr(b, table)
        eq = pc.fill_null(pc.equal(a, b_arr), False)
        return pc.if_else(eq, pa.nulls(table.num_rows, a.type), a)
    if name in ("greatest", "least"):
        parts = [_arr(evaluate(a, table), table) for a in e.args]
        fn = pc.max_element_wise if name == "greatest" else pc.min_element_wise
        return fn(*parts)
    if name in ("power", "pow"):
        a = _arr(evaluate(e.args[0], table), table)
        return pc.power(pc.cast(a, pa.float64()), float(evaluate(e.args[1], table)))
    if name in ("sqrt", "exp", "ln", "log10", "sign", "sin", "cos", "tan"):
        arr = pc.cast(_arr(evaluate(e.args[0], table), table), pa.float64())
        fn = {
            "sqrt": pc.sqrt, "exp": pc.exp, "ln": pc.ln, "log10": pc.log10,
            "sign": pc.sign, "sin": pc.sin, "cos": pc.cos, "tan": pc.tan,
        }[name]
        return fn(arr)
    if name == "log":
        # log(x) = ln, log(base, x) = logb
        if len(e.args) == 1:
            return pc.ln(pc.cast(_arr(evaluate(e.args[0], table), table), pa.float64()))
        base = float(evaluate(e.args[0], table))
        arr = pc.cast(_arr(evaluate(e.args[1], table), table), pa.float64())
        return pc.logb(arr, base)
    if name == "mod":
        a = _arr(evaluate(e.args[0], table), table)
        b = evaluate(e.args[1], table)
        return _eval_binary(S.BinaryOp("%", e.args[0], e.args[1]), table)
    if name == "trunc":
        return pc.trunc(pc.cast(_arr(evaluate(e.args[0], table), table), pa.float64()))
    if name == "pi":
        return math.pi
    if name == "md5":
        import hashlib as _hl

        arr = _arr(evaluate(e.args[0], table), table)
        return pa.array(
            [
                _hl.md5(v.encode()).hexdigest() if v is not None else None
                for v in arr.to_pylist()
            ]
        )
    raise ExecError(f"unknown function {name}")


# ---------------------------------------------------------------- aggregation


@dataclass
class AggSpec:
    func: str  # count | count_star | sum | min | max | avg | count_distinct
    arg: S.Expr | None
    out_name: str
    param: float | None = None  # percentile for approx_percentile_cont


def _collect_aggs(e: S.Expr, out: list[AggSpec], counter: list[int]) -> S.Expr:
    """Replace aggregate calls in `e` with Column refs to computed agg slots;
    append specs to `out`. Returns the rewritten expression."""
    if isinstance(e, S.FunctionCall) and e.name in S.AGGREGATE_FUNCS:
        func = e.name
        arg: S.Expr | None = None
        if func == "count" and (not e.args or isinstance(e.args[0], S.Star)):
            func = "count_star"
        elif e.args:
            arg = e.args[0]
        param: float | None = None
        if func == "approx_percentile_cont":
            func = "percentile"
            if len(e.args) != 2 or not isinstance(e.args[1], S.Literal):
                raise ExecError(
                    "approx_percentile_cont takes (column, percentile-literal)"
                )
            pv = e.args[1].value
            if not isinstance(pv, (int, float)) or isinstance(pv, bool):
                raise ExecError("percentile must be a numeric literal")
            param = float(pv)
            if not 0.0 <= param <= 1.0:
                raise ExecError("percentile must be between 0 and 1")
        elif func == "approx_median":
            func = "percentile"
            if len(e.args) != 1:
                raise ExecError("approx_median takes exactly one argument")
            param = 0.5
        slot = f"__agg{counter[0]}"
        counter[0] += 1
        out.append(AggSpec(func, arg, slot, param=param))
        return S.Column(slot)
    if isinstance(e, S.BinaryOp):
        return S.BinaryOp(e.op, _collect_aggs(e.left, out, counter), _collect_aggs(e.right, out, counter))
    if isinstance(e, S.UnaryOp):
        return S.UnaryOp(e.op, _collect_aggs(e.operand, out, counter))
    if isinstance(e, S.Cast):
        return S.Cast(_collect_aggs(e.expr, out, counter), e.type_name)
    if isinstance(e, S.Case):
        return S.Case(
            [(_collect_aggs(w, out, counter), _collect_aggs(t, out, counter)) for w, t in e.whens],
            _collect_aggs(e.else_expr, out, counter) if e.else_expr else None,
        )
    if isinstance(e, S.WindowCall):
        # windows over aggregate output (`rank() OVER (ORDER BY sum(b))`):
        # the aggregate inputs rewrite to slots; the window itself
        # evaluates post-aggregation over the interim table
        return S.WindowCall(
            e.name,
            [_collect_aggs(a, out, counter) for a in e.args],
            [_collect_aggs(p, out, counter) for p in e.partition_by],
            [S.OrderItem(_collect_aggs(o.expr, out, counter), o.desc) for o in e.order_by],
            e.frame,
        )
    return e


@dataclass
class GroupState:
    count: list[int]
    sums: list[float]
    mins: list[Any]
    maxs: list[Any]
    distincts: list[set]
    sumsqs: list[float]
    sketches: list[Any]  # QuantileSketch | None per spec
    hlls: list[Any]  # approx_distinct uint8[HLL_M] registers | None per spec


class HashAggregator:
    """Streaming partial aggregation keyed by group tuples.

    `update(table)` folds one table in; `merge(other)` combines partials
    (used by the distributed tree); `finalize()` emits one row per group.
    """

    def __init__(self, group_exprs: list[S.Expr], specs: list[AggSpec]):
        self.group_exprs = group_exprs
        self.specs = specs
        self.groups: dict[tuple, GroupState] = {}

    def _new_state(self) -> GroupState:
        n = len(self.specs)
        return GroupState(
            count=[0] * n,
            sums=[0.0] * n,
            mins=[None] * n,
            maxs=[None] * n,
            distincts=[set() for _ in range(n)],
            sumsqs=[0.0] * n,
            sketches=[None] * n,
            hlls=[None] * n,
        )

    def update(self, table: pa.Table, mask: pa.Array | None = None) -> None:
        """Vectorized partial aggregation via pyarrow group_by (the hash
        aggregate runs in Arrow's C++ kernels; only the per-*group* merge is
        Python)."""
        if mask is not None:
            table = table.filter(mask)
        if table.num_rows == 0:
            return
        n = table.num_rows
        cols: dict[str, pa.Array] = {}
        key_names = []
        for i, g in enumerate(self.group_exprs):
            key_names.append(f"__k{i}")
            cols[f"__k{i}"] = _arr(evaluate(g, table), table)
        aggs: list[tuple[str, str]] = []
        for si, spec in enumerate(self.specs):
            if spec.func == "count_star":
                continue
            cols[f"__a{si}"] = _arr(evaluate(spec.arg, table), table)
            if spec.func in ("sum", "avg"):
                aggs.append((f"__a{si}", "sum"))
                aggs.append((f"__a{si}", "count"))
            elif spec.func in ("stddev", "var"):
                # float64 before squaring: int64 squares wrap silently
                fv = pc.cast(cols[f"__a{si}"], pa.float64(), safe=False)
                cols[f"__asq{si}"] = pc.multiply(fv, fv)
                aggs.append((f"__a{si}", "sum"))
                aggs.append((f"__a{si}", "count"))
                aggs.append((f"__asq{si}", "sum"))
            elif spec.func == "min":
                aggs.append((f"__a{si}", "min"))
            elif spec.func == "max":
                aggs.append((f"__a{si}", "max"))
            elif spec.func == "count":
                aggs.append((f"__a{si}", "count"))
        aggs.append(([], "count_all"))
        tmp = pa.table(cols) if cols else pa.table({"__dummy": pa.nulls(n, pa.int8())})
        grouped = tmp.group_by(key_names, use_threads=False).aggregate(aggs)

        gcols = {name: grouped.column(name).to_pylist() for name in grouped.column_names}
        keys_lists = [gcols[k] for k in key_names]
        rows_out = len(grouped)
        for r in range(rows_out):
            key = tuple(kl[r] for kl in keys_lists)
            st = self.groups.get(key)
            if st is None:
                st = self._new_state()
                self.groups[key] = st
            for si, spec in enumerate(self.specs):
                if spec.func == "count_star":
                    st.count[si] += gcols["count_all"][r]
                elif spec.func in ("sum", "avg"):
                    st.count[si] += gcols[f"__a{si}_count"][r]
                    s = gcols[f"__a{si}_sum"][r]
                    if s is not None:
                        st.sums[si] += s
                elif spec.func in ("stddev", "var"):
                    st.count[si] += gcols[f"__a{si}_count"][r]
                    s = gcols[f"__a{si}_sum"][r]
                    if s is not None:
                        st.sums[si] += s
                    sq = gcols[f"__asq{si}_sum"][r]
                    if sq is not None:
                        st.sumsqs[si] += sq
                elif spec.func == "min":
                    v = gcols[f"__a{si}_min"][r]
                    if v is not None:
                        st.count[si] += 1
                        st.mins[si] = v if st.mins[si] is None else min(st.mins[si], v)
                elif spec.func == "max":
                    v = gcols[f"__a{si}_max"][r]
                    if v is not None:
                        st.count[si] += 1
                        st.maxs[si] = v if st.maxs[si] is None else max(st.maxs[si], v)
                elif spec.func == "count":
                    st.count[si] += gcols[f"__a{si}_count"][r]


        # percentile sketches: one argsort over combined group codes gives
        # contiguous per-group value slices; per-GROUP python only
        pct_specs = [si for si, s in enumerate(self.specs) if s.func == "percentile"]
        if pct_specs:
            if key_names:
                try:
                    codes_list, sizes = [], []
                    for k in key_names:
                        codes, d = _encode_key(tmp.column(k))
                        codes_list.append(codes)
                        sizes.append(len(d) + 1)
                    combined = _combine_codes(codes_list, sizes)
                except _FastPathUnavailable:
                    # un-encodable key type or code-space overflow: factorize
                    # row tuples in Python (rare; correctness over speed)
                    tuples = list(zip(*[tmp.column(k).to_pylist() for k in key_names]))
                    index: dict = {}
                    combined = np.fromiter(
                        (index.setdefault(tp, len(index)) for tp in tuples), np.int64, n
                    )
            else:
                combined = np.zeros(n, np.int64)
            order = np.argsort(combined, kind="stable")
            sorted_codes = combined[order]
            starts = np.flatnonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])
            bounds = np.r_[starts, n]
            # one key tuple per GROUP (first row of each slice), never per row
            first_rows = (
                tmp.select(key_names).take(pa.array(order[starts])).to_pylist()
                if key_names
                else [{} for _ in starts]
            )
            for si in pct_specs:
                col = tmp.column(f"__a{si}")
                vals = np.asarray(
                    pc.cast(col, pa.float64(), safe=False).to_numpy(zero_copy_only=False)
                )
                sorted_vals = vals[order]
                for bi in range(len(starts)):
                    lo, hi = bounds[bi], bounds[bi + 1]
                    key = tuple(first_rows[bi][k] for k in key_names)
                    st = self.groups.get(key)
                    if st is None:
                        st = self._new_state()
                        self.groups[key] = st
                    if st.sketches[si] is None:
                        st.sketches[si] = QuantileSketch()
                    st.sketches[si].update(sorted_vals[lo:hi])
                    st.count[si] = st.sketches[si].count

        # distinct: unique (keys, value) combos per chunk -> host sets
        # (exact) or HLL registers (approx_distinct; hashing the uniques
        # is equivalent to hashing every row)
        for si, spec in enumerate(self.specs):
            if spec.func not in ("count_distinct", "approx_distinct"):
                continue
            sel = key_names + [f"__a{si}"]
            uniq = tmp.select(sel).group_by(sel, use_threads=False).aggregate([])
            ucols = {name: uniq.column(name).to_pylist() for name in uniq.column_names}
            approx = spec.func == "approx_distinct"
            for r in range(len(uniq)):
                key = tuple(ucols[k][r] for k in key_names)
                v = ucols[f"__a{si}"][r]
                if v is None:
                    continue
                st = self.groups.get(key)
                if st is None:
                    st = self._new_state()
                    self.groups[key] = st
                if approx:
                    st.hlls[si] = registers_add(st.hlls[si], (v,))
                else:
                    st.distincts[si].add(v)

    @staticmethod
    def _copy_state(st: GroupState) -> GroupState:
        """Own copy of a donor's state: merge must never alias the source."""
        return GroupState(
            count=list(st.count),
            sums=list(st.sums),
            mins=list(st.mins),
            maxs=list(st.maxs),
            distincts=[set(s) for s in st.distincts],
            sumsqs=list(st.sumsqs),
            sketches=[sk.copy() if sk is not None else None for sk in st.sketches],
            hlls=[h.copy() if h is not None else None for h in st.hlls],
        )

    def merge(self, other: "HashAggregator") -> None:
        for key, st in other.groups.items():
            mine = self.groups.get(key)
            if mine is None:
                self.groups[key] = self._copy_state(st)
                continue
            for si in range(len(self.specs)):
                mine.count[si] += st.count[si]
                mine.sums[si] += st.sums[si]
                mine.sumsqs[si] += st.sumsqs[si]
                for attr, fn in (("mins", min), ("maxs", max)):
                    a = getattr(mine, attr)[si]
                    b = getattr(st, attr)[si]
                    getattr(mine, attr)[si] = b if a is None else (a if b is None else fn(a, b))
                mine.distincts[si] |= st.distincts[si]
                if st.hlls[si] is not None:
                    # merge_registers copies on the None path: registers_add
                    # mutates in place and the donor must stay untouched
                    mine.hlls[si] = merge_registers(mine.hlls[si], st.hlls[si])
                if st.sketches[si] is not None:
                    if mine.sketches[si] is None:
                        mine.sketches[si] = st.sketches[si].copy()
                    else:
                        mine.sketches[si].merge(st.sketches[si])
                    mine.count[si] = mine.sketches[si].count

    def merge_raw(
        self,
        key: tuple,
        counts: list[int],
        sums: list[float],
        mins: list,
        maxs: list,
        distincts: dict[int, set] | None = None,
        sumsqs: list[float] | None = None,
        sketches: dict[int, Any] | None = None,
        hlls: dict[int, Any] | None = None,
    ) -> None:
        """Merge one group's partials produced by a device kernel.

        `distincts` maps spec index -> set of observed values (decoded from
        the device presence bitmap); `sumsqs` carries stddev/var raw
        sum-of-squares partials; `sketches` maps spec index -> QuantileSketch
        built from the device histogram; `hlls` maps spec index -> uint8
        registers (ownership passes to the aggregator) — so device blocks
        and CPU-fallback blocks merge exactly."""
        st = self.groups.get(key)
        if st is None:
            st = self._new_state()
            self.groups[key] = st
        for si in range(len(self.specs)):
            st.count[si] += counts[si]
            st.sums[si] += sums[si]
            if sumsqs is not None:
                st.sumsqs[si] += sumsqs[si]
            for attr, vals, fn in (("mins", mins, min), ("maxs", maxs, max)):
                a = getattr(st, attr)[si]
                b = vals[si]
                getattr(st, attr)[si] = b if a is None else (a if b is None else fn(a, b))
        for si, vals_set in (distincts or {}).items():
            st.distincts[si] |= vals_set
        for si, regs in (hlls or {}).items():
            if st.hlls[si] is None:
                st.hlls[si] = regs
            else:
                np.maximum(st.hlls[si], regs, out=st.hlls[si])
        for si, sk in (sketches or {}).items():
            if st.sketches[si] is None:
                st.sketches[si] = sk
            else:
                st.sketches[si].merge(sk)
            st.count[si] = st.sketches[si].count

    def finalize_value(self, st: GroupState, si: int) -> Any:
        spec = self.specs[si]
        if spec.func in ("count_star", "count"):
            return st.count[si]
        if spec.func == "sum":
            return st.sums[si] if st.count[si] else None
        if spec.func == "avg":
            return st.sums[si] / st.count[si] if st.count[si] else None
        if spec.func == "min":
            return st.mins[si]
        if spec.func == "max":
            return st.maxs[si]
        if spec.func == "count_distinct":
            return len(st.distincts[si])
        if spec.func == "approx_distinct":
            if st.hlls[si] is None:
                return 0
            return int(round(estimate(st.hlls[si])))
        if spec.func in ("stddev", "var"):
            # sample variance (n-1 denominator, DataFusion semantics)
            n = st.count[si]
            if n < 2:
                return None
            var = (st.sumsqs[si] - st.sums[si] ** 2 / n) / (n - 1)
            var = max(0.0, var)  # guard f.p. negatives
            return math.sqrt(var) if spec.func == "stddev" else var
        if spec.func == "percentile":
            sk = st.sketches[si]
            if sk is None:
                return None
            return sk.quantile(spec.param if spec.param is not None else 0.5)
        raise ExecError(f"unknown aggregate {spec.func}")


# ------------------------------------------------------------------- executor


class QueryExecutor:
    """Execute a LogicalPlan over an iterator of tables (CPU engine)."""

    # set by the session when the query can use the result cache: receives
    # the merged interim the moment the scan is fully reduced, before
    # HAVING, projection, ORDER BY and LIMIT run. Every aggregate path of
    # both engines ends in finalize_from_interim, so one hook covers them
    interim_sink = None
    # the distributed pushdown's hook (query/fanout.py): called once the
    # local scan's blocks have all reduced, it returns the peers' partial
    # tables to fold into the same merge, so the peers' work overlaps the
    # local scan instead of preceding it
    partials_source = None
    # the caller's options, whose staging dir roots the process-wide link
    # profile; None leaves it where it is (the GPU executor sets its own)
    _staging_options = None

    def __init__(self, plan: LogicalPlan):
        self.plan = plan

    # -- shared pieces -------------------------------------------------------

    def _check_deadline(self) -> None:
        """Cooperative timeout, checked once per scan block."""
        dl = getattr(self.plan, "deadline", None)
        if dl is not None and time.monotonic() > dl:
            raise QueryTimeout("query exceeded its timeout and was cancelled")

    def _memory_budget(self) -> int | None:
        return getattr(self.plan, "memory_limit_bytes", None)

    def _where_mask(self, table: pa.Table) -> pa.Array | None:
        w = self.plan.select.where
        if w is None:
            return None
        mask = _arr(evaluate(w, table), table)
        if not pa.types.is_boolean(mask.type):
            raise ExecError("WHERE must be boolean")
        return mask

    def _bounds_filter(self, table: pa.Table) -> pa.Table:
        """Row-level time-bounds filter (scan tables arrive unfiltered so
        their device encodings stay query-independent)."""
        from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY

        tb = self.plan.time_bounds
        if (tb.low is None and tb.high is None) or DEFAULT_TIMESTAMP_KEY not in table.column_names:
            return table
        return table.filter(time_bounds_mask(table.column(DEFAULT_TIMESTAMP_KEY), tb.low, tb.high))

    def execute(self, tables: Iterator[pa.Table]) -> pa.Table:
        if self.plan.is_aggregate:
            return self._execute_aggregate(tables)
        return self._execute_select(tables)

    def _execute_select(self, tables: Iterator[pa.Table]) -> pa.Table:
        sel = self.plan.select
        if any(S.contains_window(i.expr) for i in sel.items) or any(
            S.contains_window(o.expr) for o in sel.order_by
        ):
            raise ExecError("window functions are not ported yet")
        out_parts: list[pa.Table] = []
        rows_needed = None
        if sel.limit is not None and not sel.distinct:
            rows_needed = sel.limit + (sel.offset or 0)
        # top-K pushdown: with ORDER BY + LIMIT, periodically sort-compact
        # the working set down to the K needed rows instead of materializing
        # the whole scan (reference leans on DataFusion's sort-limit;
        # `SELECT * ... LIMIT 100` over 100 GB must not OOM)
        topk = rows_needed is not None and bool(sel.order_by)
        compact_at = max(2 * (rows_needed or 0), 100_000)
        budget = self._memory_budget()
        held_bytes = 0
        total = 0
        for table in tables:
            self._check_deadline()
            table = self._bounds_filter(table)
            mask = self._where_mask(table)
            if mask is not None:
                table = table.filter(mask)
            if table.num_rows == 0:
                continue
            part = self._project(table)
            out_parts.append(part)
            total += part.num_rows
            held_bytes += part.nbytes
            if rows_needed is not None and not sel.order_by and total >= rows_needed:
                break
            # compact on row count OR budget pressure — a tight memory cap
            # must trigger top-K compaction, not fail a bounded query
            if topk and (total >= compact_at or (budget is not None and held_bytes > budget)):
                compacted = self._sorted(_unify_parts(out_parts)).slice(0, rows_needed)
                out_parts = [compacted]
                total = compacted.num_rows
                held_bytes = compacted.nbytes
            if budget is not None and held_bytes > budget:
                raise MemoryLimitExceeded(
                    f"query holds {held_bytes} bytes of results "
                    f"(limit {budget}); add LIMIT/filters or raise P_QUERY_MEMORY_LIMIT"
                )
        if not out_parts:
            return self._project(_empty_like(self.plan))
        result = _unify_parts(out_parts)
        if sel.distinct:
            result = result.group_by(result.column_names).aggregate([])
        result = self._order_limit(result)
        return self._strip_order_carry(result)

    def _strip_order_carry(self, result: pa.Table) -> pa.Table:
        sel = self.plan.select
        if any(isinstance(i.expr, S.Star) for i in sel.items):
            return result
        declared = [i.alias or S.expr_name(i.expr) for i in sel.items]
        carried = [
            S.expr_name(o.expr)
            for o in sel.order_by
            if S.expr_name(o.expr) not in declared
        ]
        if not carried:
            return result
        keep = [c for c in result.column_names if c not in carried]
        return result.select(keep)

    def _order_carry_names(self, declared: list[str], table: pa.Table) -> list[str]:
        """ORDER BY columns the projection would drop: carried through the
        output under their own names so the final sort can see them, then
        stripped (`SELECT ms FROM t ORDER BY rn` must sort by rn, not by an
        all-null placeholder)."""
        from parseable_tpu_torch.query.planner import referenced_columns

        sel = self.plan.select
        out: list[str] = []
        if sel.distinct:
            # DISTINCT + ORDER BY an unselected column is ill-defined
            return out
        for o in sel.order_by:
            nm = S.expr_name(o.expr)
            if nm in declared or nm in out:
                continue
            refs = referenced_columns(o.expr)
            if refs and all(r in table.column_names for r in refs):
                out.append(nm)
        return out

    def _project(self, table: pa.Table) -> pa.Table:
        sel = self.plan.select
        names: list[str] = []
        arrays: list[pa.Array] = []
        for item in sel.items:
            if isinstance(item.expr, S.Star):
                prefix = f"{item.expr.table}." if item.expr.table else None
                cols = table.column_names
                if prefix is not None:
                    qualified = [n for n in cols if n.startswith(prefix)]
                    # single-table scans have unqualified columns; `r.*`
                    # over them means everything
                    cols = qualified or cols
                for name in cols:
                    names.append(name)
                    arrays.append(table.column(name).combine_chunks())
                continue
            names.append(item.alias or S.expr_name(item.expr))
            arrays.append(_arr(evaluate(item.expr, table), table))
        if not any(isinstance(i.expr, S.Star) for i in sel.items):
            for nm in self._order_carry_names(names, table):
                for o in sel.order_by:
                    if S.expr_name(o.expr) == nm:
                        names.append(nm)
                        arrays.append(_arr(evaluate(o.expr, table), table))
                        break
        return pa.table(dict(zip(names, arrays)) if len(set(names)) == len(names) else _dedup(names, arrays))

    # -- aggregate -----------------------------------------------------------

    def build_aggregator(self) -> tuple[HashAggregator, list[S.SelectItem], list[str]]:
        """Construct the aggregator + rewritten post-agg select items."""
        sel = self.plan.select
        specs: list[AggSpec] = []
        counter = [0]
        rewritten: list[S.SelectItem] = []
        for item in sel.items:
            new_expr = _collect_aggs(item.expr, specs, counter)
            rewritten.append(S.SelectItem(new_expr, item.alias or S.expr_name(item.expr)))
        having = _collect_aggs(sel.having, specs, counter) if sel.having else None
        group_names = [S.expr_name(g) for g in sel.group_by]
        agg = HashAggregator(sel.group_by, specs)
        self._having = having
        return agg, rewritten, group_names

    def _execute_aggregate(self, tables: Iterator[pa.Table]) -> pa.Table:
        agg, rewritten, group_names = self.build_aggregator()
        sel = self.plan.select
        if sel.group_by and PT.specs_partializable(agg.specs):
            # two-phase: per-block pyarrow partials + ONE vectorized merge, no
            # per-group Python, so a 1M-group query does not cliff
            link = get_link(self._staging_options)
            parts: list[pa.Table] = []
            for table in tables:
                self._check_deadline()
                t0 = time.perf_counter()
                # the host rate counts the block's rows before the bounds
                # filter: the basis the GPU engine's gate prices blocks on
                rows_scanned = table.num_rows
                table = self._bounds_filter(table)
                mask = self._where_mask(table)
                if mask is not None:
                    table = table.filter(mask)
                pt = PT.partial_from_block(table, sel.group_by, agg.specs)
                if pt is not None:
                    parts.append(pt)
                link.record_cpu_agg(rows_scanned, time.perf_counter() - t0)
            if self.partials_source is not None:
                # the peers' combined partials join the local blocks in ONE
                # merge (the same funnel: avg and stddev stay exact)
                parts.extend(self.partials_source())
            if parts:
                interim = PT.merge_partials(parts, agg.specs, len(sel.group_by))
                return self.finalize_from_interim(interim, rewritten)
            return self.finalize_aggregate(agg, rewritten, group_names)
        for table in tables:
            self._check_deadline()
            table = self._bounds_filter(table)
            mask = self._where_mask(table)
            agg.update(table, mask)
        return self.finalize_aggregate(agg, rewritten, group_names)

    def partial_tables(self, tables: Iterator[pa.Table]) -> list[pa.Table]:
        """Scan -> per-block partial tables, with no merge or finalize: the
        peer half of the distributed pushdown (`combine_partials` folds the
        blocks into one wire-ready partial). The bounds filter and WHERE
        mask are those of `_execute_aggregate`'s two-phase loop."""
        agg, _rewritten, _names = self.build_aggregator()
        sel = self.plan.select
        parts: list[pa.Table] = []
        for table in tables:
            self._check_deadline()
            table = self._bounds_filter(table)
            mask = self._where_mask(table)
            if mask is not None:
                table = table.filter(mask)
            pt = PT.partial_from_block(table, sel.group_by, agg.specs)
            if pt is not None:
                parts.append(pt)
        return parts

    def finalize_aggregate(
        self, agg: HashAggregator, rewritten: list[S.SelectItem], group_names: list[str]
    ) -> pa.Table:
        sel = self.plan.select
        if not agg.groups and not sel.group_by:
            agg.groups[()] = agg._new_state()
        # build a table of group keys + agg slots
        cols: dict[str, list] = {f"__g{i}": [] for i in range(len(sel.group_by))}
        for si in range(len(agg.specs)):
            cols[f"__agg{si}"] = []
        for key, st in agg.groups.items():
            for i, kv in enumerate(key):
                cols[f"__g{i}"].append(kv)
            for si in range(len(agg.specs)):
                cols[f"__agg{si}"].append(agg.finalize_value(st, si))
        interim = pa.table(cols) if cols else pa.table({"__dummy": [None] * len(agg.groups)})
        return self.finalize_from_interim(interim, rewritten)

    def finalize_from_interim(self, interim: pa.Table, rewritten: list[S.SelectItem]) -> pa.Table:
        """Post-aggregation: HAVING, projection over __g/__agg slots, ORDER
        BY/LIMIT. Shared by the sparse (dict) fold and the TPU engine's
        vectorized dense finalize."""
        if self.interim_sink is not None:
            self.interim_sink(interim)
        sel = self.plan.select

        # group exprs referenced post-agg resolve to the key columns.
        # Keyed by structural repr, not display name: `l.a` and `o.a` share
        # the name "a" but are different group keys.
        remap: dict[str, str] = {}
        for i, g in enumerate(sel.group_by):
            remap[repr(g)] = f"__g{i}"
            remap.setdefault(S.expr_name(g), f"__g{i}")

        def rewrite_groups(e: S.Expr) -> S.Expr:
            nm = repr(e)
            if nm in remap:
                return S.Column(remap[nm])
            nm = S.expr_name(e)
            if nm in remap and not isinstance(e, S.Column):
                return S.Column(remap[nm])
            if isinstance(e, S.Column) and e.table is None and nm in remap:
                return S.Column(remap[nm])
            if isinstance(e, S.BinaryOp):
                return S.BinaryOp(e.op, rewrite_groups(e.left), rewrite_groups(e.right))
            if isinstance(e, S.UnaryOp):
                return S.UnaryOp(e.op, rewrite_groups(e.operand))
            if isinstance(e, S.Cast):
                return S.Cast(rewrite_groups(e.expr), e.type_name)
            if isinstance(e, S.WindowCall):
                return S.WindowCall(
                    e.name,
                    [rewrite_groups(a) for a in e.args],
                    [rewrite_groups(p) for p in e.partition_by],
                    [S.OrderItem(rewrite_groups(o.expr), o.desc) for o in e.order_by],
                    e.frame,
                )
            return e

        def project(interim: pa.Table) -> pa.Table:
            if getattr(self, "_having", None) is not None:
                hmask = _arr(evaluate(rewrite_groups(self._having), interim), interim)
                interim = interim.filter(hmask)

            items = [S.SelectItem(rewrite_groups(i.expr), i.alias) for i in rewritten]
            if any(S.contains_window(i.expr) for i in items):
                raise ExecError("window functions are not ported yet")
            names, arrays = [], []
            for item in items:
                names.append(item.alias)
                arrays.append(_arr(evaluate(item.expr, interim), interim))
            return pa.table(_dedup(names, arrays))

        try:
            result = project(interim)
        except (pa.ArrowNotImplementedError, pa.ArrowInvalid, pa.ArrowTypeError):
            # a kernel without dictionary support hit a dictionary-typed key
            # column (high-cardinality interims keep string keys encoded):
            # decode once and retry
            result = project(decode_dictionary_columns(interim))
        result = self._order_limit(result)
        # dictionary keys stay encoded through group/merge/order-limit;
        # the boundary decodes them so downstream consumers (union, joins,
        # serializers) see plain columns — post-LIMIT this is rows-out work
        return decode_dictionary_columns(result)

    # -- order / limit -------------------------------------------------------

    def _sort_keys(self, table: pa.Table) -> tuple[pa.Table, list[tuple[str, str]]]:
        """Resolve ORDER BY keys (aux columns appended for expression keys;
        an integer literal n names the n-th output column, as in
        DataFusion)."""
        sel = self.plan.select
        keys: list[tuple[str, str]] = []
        aux_cols = 0
        if any(isinstance(i.expr, S.Star) for i in sel.items):
            outputs = list(table.column_names)
        else:  # by name: a select's parts unify into name order
            outputs = list(_dedup([i.alias or S.expr_name(i.expr) for i in sel.items], sel.items))
        for o in sel.order_by:
            name = S.expr_name(o.expr)
            value = o.expr.value if isinstance(o.expr, S.Literal) else None
            if isinstance(value, int) and not isinstance(value, bool):
                if not 1 <= value <= len(outputs):
                    raise ExecError(
                        f"ORDER BY position {value} is not in the select list (1..{len(outputs)})"
                    )
                keys.append((outputs[value - 1], "descending" if o.desc else "ascending"))
            elif isinstance(o.expr, S.Column) and o.expr.name in table.column_names:
                keys.append((o.expr.name, "descending" if o.desc else "ascending"))
            elif name in table.column_names:
                keys.append((name, "descending" if o.desc else "ascending"))
            else:
                if S.contains_window(o.expr):
                    raise ExecError(
                        "a window function in ORDER BY of an aggregate query "
                        "must also appear in the SELECT list (alias it and "
                        "order by the alias)"
                    )
                aux = f"__sort{aux_cols}"
                aux_cols += 1
                table = table.append_column(aux, _arr(evaluate(o.expr, table), table))
                keys.append((aux, "descending" if o.desc else "ascending"))
        return table, keys

    @staticmethod
    def _drop_aux(table: pa.Table) -> pa.Table:
        return table.select([c for c in table.column_names if not c.startswith("__sort")])

    def _sorted(self, table: pa.Table) -> pa.Table:
        """ORDER BY sort (aux columns for expression keys, dropped after)."""
        table, keys = self._sort_keys(table)
        try:
            table = table.sort_by(keys)
        except (pa.ArrowNotImplementedError, pa.ArrowInvalid, pa.ArrowTypeError):
            table = decode_dictionary_columns(table).sort_by(keys)
        return self._drop_aux(table)

    def _order_limit(self, table: pa.Table) -> pa.Table:
        sel = self.plan.select
        off = sel.offset or 0
        if sel.order_by:
            k = None if sel.limit is None else off + sel.limit
            if k is not None and 0 < k and table.num_rows > max(k * 4, 1024):
                # top-K selection instead of a full sort: a LIMIT over a
                # million-group aggregate is a partial-select, not a sort
                # (DataFusion's TopK operator; reference gets this from
                # src/query/mod.rs DataFusion planner)
                keyed, keys = self._sort_keys(table)
                if any(
                    pa.types.is_dictionary(keyed.column(name).type) for name, _ in keys
                ):
                    # select_k_unstable SEGFAULTS (not raises) on dictionary
                    keyed = decode_dictionary_columns(keyed)
                try:
                    idx = pc.select_k_unstable(
                        keyed, options=pc.SelectKOptions(k=k, sort_keys=keys)
                    )
                    table = self._drop_aux(keyed.take(idx))
                except (pa.ArrowNotImplementedError, pa.ArrowInvalid, pa.ArrowTypeError):
                    table = self._sorted(table)
            else:
                table = self._sorted(table)
        if off:
            table = table.slice(off)
        if sel.limit is not None:
            table = table.slice(0, sel.limit)
        return table


def _unify_parts(parts: list[pa.Table]) -> pa.Table:
    from parseable_tpu_torch.utils.arrowutil import adapt_batch, merge_schemas

    schema = merge_schemas([t.schema for t in parts])
    unified = []
    for t in parts:
        for b in t.to_batches():
            unified.append(adapt_batch(schema, b))
    return pa.Table.from_batches(unified, schema=schema)


def _dedup(names: list[str], arrays: list) -> dict:
    out = {}
    for n, a in zip(names, arrays):
        base, k = n, 1
        while n in out:
            n = f"{base}_{k}"
            k += 1
        out[n] = a
    return out


def _empty_like(plan: LogicalPlan) -> pa.Table:
    """Zero-row table typed from the stream schema (string for unknowns) so
    select-list expressions still evaluate when the scan matched nothing."""
    hint: pa.Schema | None = plan.schema_hint  # type: ignore[assignment]
    known = {f.name: f.type for f in hint} if hint is not None else {}
    cols = plan.needed_columns if plan.needed_columns is not None else set(known)
    out = {c: pa.array([], type=known.get(c, pa.string())) for c in sorted(cols)}
    return pa.table(out or {"__empty": pa.array([], pa.int64())})

