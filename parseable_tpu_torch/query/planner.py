"""Logical planning: time-filter extraction, predicate analysis, plan shape.

Parity targets (reference: src/query/mod.rs:385-423 final_logical_plan time
injection; src/query/stream_schema_provider.rs:705-944 PartialTimeFilter
extraction + manifest pruning bounds).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from datetime import UTC, datetime, timedelta

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY
from parseable_tpu_torch.catalog import ManifestFile
from parseable_tpu_torch.query import sql as S
from parseable_tpu_torch.utils.timeutil import parse_rfc3339


@dataclass
class TimeBounds:
    """[low, high) bounds on the event timestamp column."""

    low: datetime | None = None
    high: datetime | None = None

    def intersect(self, other: "TimeBounds") -> "TimeBounds":
        low = max(filter(None, [self.low, other.low]), default=None)
        high = min(filter(None, [self.high, other.high]), default=None)
        return TimeBounds(low, high)


def _as_datetime(v) -> datetime | None:
    if isinstance(v, datetime):
        return v if v.tzinfo else v.replace(tzinfo=UTC)
    if isinstance(v, str):
        try:
            return parse_rfc3339(v)
        except ValueError:
            return None
    if isinstance(v, (int, float)):
        return datetime.fromtimestamp(v / 1000.0, UTC)
    return None


def _next_ms(dt: datetime) -> datetime:
    """The millisecond after the one `dt` falls in: ts > dt and ts <= dt are
    ts >= _next_ms(dt) and ts < _next_ms(dt) on ms values, sub-ms dt too."""
    return dt - timedelta(microseconds=dt.microsecond % 1000) + timedelta(milliseconds=1)


def extract_time_bounds(where: S.Expr | None, time_col: str = DEFAULT_TIMESTAMP_KEY) -> TimeBounds:
    """Pull conjunctive p_timestamp bounds out of a WHERE expression.

    Only top-level ANDs contribute (an OR can't restrict the scan window),
    matching the reference's PartialTimeFilter semantics.
    """
    bounds = TimeBounds()
    if where is None:
        return bounds

    def visit(e: S.Expr) -> None:
        nonlocal bounds
        if isinstance(e, S.BinaryOp) and e.op == "and":
            visit(e.left)
            visit(e.right)
            return
        if isinstance(e, S.Between) and not e.negated:
            if _col_name(e.expr) == time_col:
                lo = _literal_dt(e.low)
                hi = _literal_dt(e.high)
                if lo:
                    bounds = bounds.intersect(TimeBounds(low=lo))
                if hi:
                    bounds = bounds.intersect(TimeBounds(high=_next_ms(hi)))
            return
        if isinstance(e, S.BinaryOp) and e.op in ("<", "<=", ">", ">=", "="):
            left_col = _col_name(e.left)
            right_col = _col_name(e.right)
            if left_col == time_col and right_col is None:
                dt = _literal_dt(e.right)
                if dt is None:
                    return
                # bounds are [low, high) at millisecond resolution, so the
                # strict ops need a nudge to the next ms to stay
                # exclusive/inclusive (sub-ms bounds round up when applied).
                if e.op == ">":
                    bounds = bounds.intersect(TimeBounds(low=_next_ms(dt)))
                elif e.op == ">=":
                    bounds = bounds.intersect(TimeBounds(low=dt))
                elif e.op == "<":
                    bounds = bounds.intersect(TimeBounds(high=dt))
                elif e.op == "<=":
                    bounds = bounds.intersect(TimeBounds(high=_next_ms(dt)))
                else:  # =
                    bounds = bounds.intersect(TimeBounds(low=dt, high=_next_ms(dt)))
            elif right_col == time_col and left_col is None:
                dt = _literal_dt(e.left)
                if dt is None:
                    return
                if e.op == "<":  # dt < ts  ==  ts > dt
                    bounds = bounds.intersect(TimeBounds(low=_next_ms(dt)))
                elif e.op == "<=":
                    bounds = bounds.intersect(TimeBounds(low=dt))
                elif e.op == ">":  # dt > ts  ==  ts < dt
                    bounds = bounds.intersect(TimeBounds(high=dt))
                elif e.op == ">=":
                    bounds = bounds.intersect(TimeBounds(high=_next_ms(dt)))
                else:  # =
                    bounds = bounds.intersect(TimeBounds(low=dt, high=_next_ms(dt)))

    visit(where)
    return bounds


def _col_name(e: S.Expr) -> str | None:
    if isinstance(e, S.Column):
        return e.name
    if isinstance(e, S.Cast):
        return _col_name(e.expr)
    return None


def _literal_dt(e: S.Expr) -> datetime | None:
    if isinstance(e, S.Literal):
        return _as_datetime(e.value)
    if isinstance(e, S.Cast):
        return _literal_dt(e.expr)
    if isinstance(e, S.FunctionCall) and e.name == "to_timestamp" and e.args:
        return _literal_dt(e.args[0])
    return None


@dataclass
class ColumnConstraint:
    """One conjunctive comparison usable for min/max stats pruning."""

    column: str
    op: str  # = != < <= > >=
    value: object


def extract_column_constraints(where: S.Expr | None) -> list[ColumnConstraint]:
    out: list[ColumnConstraint] = []
    if where is None:
        return out

    def visit(e: S.Expr) -> None:
        if isinstance(e, S.BinaryOp) and e.op == "and":
            visit(e.left)
            visit(e.right)
            return
        if isinstance(e, S.BinaryOp) and e.op in ("=", "!=", "<", "<=", ">", ">="):
            lc, rc = _col_name(e.left), _col_name(e.right)
            if lc and isinstance(e.right, S.Literal):
                out.append(ColumnConstraint(lc, e.op, e.right.value))
            elif rc and isinstance(e.left, S.Literal):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                out.append(ColumnConstraint(rc, flip.get(e.op, e.op), e.left.value))
        if isinstance(e, S.Between) and not e.negated:
            c = _col_name(e.expr)
            if c and isinstance(e.low, S.Literal) and isinstance(e.high, S.Literal):
                out.append(ColumnConstraint(c, ">=", e.low.value))
                out.append(ColumnConstraint(c, "<=", e.high.value))

    visit(where)
    return out


def prune_file(entry: ManifestFile, constraints: list[ColumnConstraint]) -> bool:
    """True if the file may contain matching rows (stats overlap check)
    (reference: stream_schema_provider.rs:946-1065)."""
    stats = entry.column_stats()
    for c in constraints:
        st = stats.get(c.column)
        if st is None:
            continue
        v = c.value
        if isinstance(v, str) and st.kind == "Int":
            dt = _as_datetime(v)
            if dt is None:
                continue
            v = int(dt.timestamp() * 1000)
        if isinstance(v, bool) and st.kind != "Bool":
            continue
        try:
            if c.op == "=" and not (st.min <= v <= st.max):
                return False
            if c.op == "<" and not (st.min < v):
                return False
            if c.op == "<=" and not (st.min <= v):
                return False
            if c.op == ">" and not (st.max > v):
                return False
            if c.op == ">=" and not (st.max >= v):
                return False
        except TypeError:
            continue  # incomparable types: cannot prune
    return True


def _is_pure_time_range(where: S.Expr | None, time_col: str = DEFAULT_TIMESTAMP_KEY) -> bool:
    """True when WHERE is None or only ANDed range comparisons/BETWEEN on the
    timestamp column — i.e. fully captured by extract_time_bounds."""
    if where is None:
        return True
    if isinstance(where, S.BinaryOp) and where.op == "and":
        return _is_pure_time_range(where.left) and _is_pure_time_range(where.right)
    if isinstance(where, S.BinaryOp) and where.op in ("<", "<=", ">", ">=", "="):
        lc, rc = _col_name(where.left), _col_name(where.right)
        if lc == time_col and rc is None:
            return _literal_dt(where.right) is not None
        if rc == time_col and lc is None:
            return _literal_dt(where.left) is not None
        return False
    if isinstance(where, S.Between) and not where.negated:
        return (
            _col_name(where.expr) == time_col
            and _literal_dt(where.low) is not None
            and _literal_dt(where.high) is not None
        )
    return False


def referenced_columns(e: S.Expr | None) -> set[str]:
    cols: set[str] = set()
    if e is None:
        return cols

    def visit(x: S.Expr) -> None:
        if isinstance(x, S.Subquery):
            return  # inner select's columns belong to the inner stream
        if isinstance(x, S.Column):
            cols.add(x.name)
        elif isinstance(x, S.BinaryOp):
            visit(x.left)
            visit(x.right)
        elif isinstance(x, S.UnaryOp):
            visit(x.operand)
        elif isinstance(x, S.InList):
            visit(x.expr)
            for i in x.items:
                visit(i)
        elif isinstance(x, S.Between):
            visit(x.expr)
            visit(x.low)
            visit(x.high)
        elif isinstance(x, S.IsNull):
            visit(x.expr)
        elif isinstance(x, S.FunctionCall):
            for a in x.args:
                visit(a)
        elif isinstance(x, S.WindowCall):
            for a in x.args:
                visit(a)
            for p in x.partition_by:
                visit(p)
            for o in x.order_by:
                visit(o.expr)
        elif isinstance(x, S.Cast):
            visit(x.expr)
        elif isinstance(x, S.Case):
            for w, t in x.whens:
                visit(w)
                visit(t)
            if x.else_expr is not None:
                visit(x.else_expr)

    visit(e)
    return cols


@dataclass
class LogicalPlan:
    """Resolved single-stream plan."""

    select: S.Select
    stream: str
    time_bounds: TimeBounds
    constraints: list[ColumnConstraint]
    needed_columns: set[str] | None  # None = all (select *)
    aggregates: list[S.SelectItem] = dc_field(default_factory=list)
    is_aggregate: bool = False
    # stream schema, when known — typed empty results, projection validation
    schema_hint: object | None = None  # pa.Schema
    # scan's overall [min, max] event time (from manifests): lets the TPU
    # engine pre-size time-bin group capacities and flush exactly once
    scan_time_hint: tuple[datetime, datetime] | None = None
    # True when p_timestamp entered needed_columns only for time-bounds
    # filtering: a query with no bounds can then skip encoding/shipping the
    # column entirely (transfer bytes are the cold-scan budget)
    ts_artificial: bool = False
    # safety rails (set by the session from Options; reference:
    # query/mod.rs:92,152-165 timeout + :216-226 memory pool)
    deadline: float | None = None  # time.monotonic() cutoff
    memory_limit_bytes: int | None = None
    execution_batch_size: int | None = None  # streaming emission chunk rows

    @property
    def count_star_only(self) -> bool:
        """Fast path: bare `SELECT count(*)` whose WHERE is *entirely* a
        conjunctive p_timestamp range (everything extract_time_bounds
        captured) — served from manifest row counts without touching data
        (reference: query/mod.rs:425-462). OR / != / IS NULL time predicates
        disqualify it: their semantics aren't carried by the bounds.
        """
        if self.select.group_by or self.select.distinct:
            return False
        # constraints on the time column are fully captured by the bounds
        # (given the purity check below); any other column disqualifies
        if any(c.column != DEFAULT_TIMESTAMP_KEY for c in self.constraints):
            return False
        if not _is_pure_time_range(self.select.where):
            return False
        if len(self.select.items) != 1:
            return False
        e = self.select.items[0].expr
        return (
            isinstance(e, S.FunctionCall)
            and e.name == "count"
            and (not e.args or isinstance(e.args[0], S.Star))
        )


def _substitute_aliases(e: S.Expr, aliases: dict[str, S.Expr]) -> S.Expr:
    if isinstance(e, S.Column) and e.name in aliases:
        return aliases[e.name]
    if isinstance(e, S.BinaryOp):
        return S.BinaryOp(
            e.op, _substitute_aliases(e.left, aliases), _substitute_aliases(e.right, aliases)
        )
    if isinstance(e, S.UnaryOp):
        return S.UnaryOp(e.op, _substitute_aliases(e.operand, aliases))
    if isinstance(e, S.FunctionCall):
        return S.FunctionCall(
            e.name, [_substitute_aliases(a, aliases) for a in e.args], e.distinct
        )
    if isinstance(e, S.Cast):
        return S.Cast(_substitute_aliases(e.expr, aliases), e.type_name)
    return e


def plan(select: S.Select) -> LogicalPlan:
    if select.table is None:
        raise S.SqlError("query has no FROM table")

    # GROUP BY / ORDER BY / HAVING may reference select aliases
    # (e.g. `SELECT date_bin(...) AS b ... GROUP BY b`): inline them
    aliases = {
        item.alias: item.expr
        for item in select.items
        if item.alias is not None and not isinstance(item.expr, S.Star)
    }
    if aliases:
        # ORDER BY aliases resolve against the *output* table, so they stay;
        # GROUP BY / HAVING run input-side and need the real expressions
        select.group_by = [_substitute_aliases(g, aliases) for g in select.group_by]
        if select.having is not None:
            select.having = _substitute_aliases(select.having, aliases)

    bounds = extract_time_bounds(select.where)
    constraints = extract_column_constraints(select.where)

    needed: set[str] | None = set()
    ts_artificial = False
    for item in select.items:
        if isinstance(item.expr, S.Star):
            needed = None
            break
        needed |= referenced_columns(item.expr)
    if needed is not None:
        needed |= referenced_columns(select.where)
        for g in select.group_by:
            needed |= referenced_columns(g)
        needed |= referenced_columns(select.having)
        # ORDER BY resolves select ALIASES against the output table; an
        # alias name is not an input column (it would poison column-pruned
        # scans and encoded-cache lookups with a phantom column)
        alias_names = {i.alias for i in select.items if i.alias}
        for o in select.order_by:
            needed |= referenced_columns(o.expr) - alias_names
        # engines row-filter by time bounds themselves (scan tables arrive
        # unfiltered so device encodings stay query-independent)
        ts_artificial = DEFAULT_TIMESTAMP_KEY not in needed
        needed.add(DEFAULT_TIMESTAMP_KEY)

    is_agg = bool(select.group_by) or any(S.is_aggregate(i.expr) for i in select.items)
    return LogicalPlan(
        select=select,
        stream=select.table,
        time_bounds=bounds,
        constraints=constraints,
        needed_columns=needed,
        is_aggregate=is_agg,
        ts_artificial=ts_artificial,
    )
