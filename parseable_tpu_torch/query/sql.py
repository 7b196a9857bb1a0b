"""SQL front end: lexer + recursive-descent parser -> AST.

The reference embeds DataFusion for SQL (src/query/mod.rs); this build has no
embeddable SQL engine available, so we parse the observability SQL dialect
ourselves. Coverage targets every query shape the reference's handlers,
alerts and benchmarks issue:

    SELECT [DISTINCT] exprs FROM stream
      [WHERE expr] [GROUP BY exprs] [HAVING expr]
      [ORDER BY expr [ASC|DESC], ...] [LIMIT n [OFFSET m]]

with operators AND/OR/NOT, comparisons, arithmetic, IN, BETWEEN, LIKE/ILIKE,
IS [NOT] NULL, CASE WHEN, CAST, and functions (count/sum/avg/min/max,
count(distinct), approx_distinct, approx_percentile_cont, approx_median,
stddev/var, date_bin, date_trunc, to_timestamp, lower/upper/length/
coalesce, ...). `EXPLAIN [ANALYZE]` prefixes any statement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# --------------------------------------------------------------------- lexer

KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "offset", "and", "or", "not", "in", "between", "like", "ilike",
    "is", "null", "as", "asc", "desc", "case", "when", "then", "else", "end",
    "cast", "true", "false", "interval",
}

# Contextual words recognized only inside the FROM clause — log fields named
# "left"/"on"/"join" must keep parsing as plain columns elsewhere.
JOIN_WORDS = {"join", "inner", "left", "right", "full", "outer", "cross", "on"}

# contextual words that terminate an implicit alias position ("FROM t UNION"
# must not read UNION as t's alias)
NON_ALIAS_WORDS = JOIN_WORDS | {"union"}


@dataclass
class Token:
    kind: str  # kw | ident | number | string | op | eof
    value: Any
    pos: int


class SqlError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot) or sql[j] in "eE" or (sql[j] in "+-" and sql[j - 1] in "eE")):
                if sql[j] == ".":
                    seen_dot = True
                j += 1
            text = sql[i:j]
            try:
                value = int(text)
            except ValueError:
                try:
                    value = float(text)
                except ValueError:
                    # malformed exponent like "1.5e" must surface as a
                    # parse error, not an unhandled 500
                    raise SqlError(f"invalid number literal {text!r} at {i}") from None
            tokens.append(Token("number", value, i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            lw = word.lower()
            if lw in KEYWORDS:
                tokens.append(Token("kw", lw, i))
            else:
                tokens.append(Token("ident", word, i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SqlError(f"unterminated string at {i}")
            tokens.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            tokens.append(Token("ident", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            tokens.append(Token("ident", sql[i + 1 : j], i))
            i = j + 1
            continue
        two = sql[i : i + 2]
        if two in ("<=", ">=", "!=", "<>", "||"):
            tokens.append(Token("op", "!=" if two == "<>" else two, i))
            i += 2
            continue
        if c in "+-*/%(),.<>=;":
            tokens.append(Token("op", c, i))
            i += 1
            continue
        raise SqlError(f"unexpected character {c!r} at {i}")
    tokens.append(Token("eof", None, n))
    return tokens


# ----------------------------------------------------------------------- AST


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any  # int | float | str | bool | None


@dataclass
class Column(Expr):
    name: str
    table: str | None = None


@dataclass
class Star(Expr):
    table: str | None = None  # `alias.*` keeps its qualifier


@dataclass
class UnaryOp(Expr):
    op: str  # "-" | "not"
    operand: Expr


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= and or like ilike ||
    left: Expr
    right: Expr


@dataclass
class InList(Expr):
    expr: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass
class FunctionCall(Expr):
    name: str  # lowercase
    args: list[Expr]
    distinct: bool = False


@dataclass
class Cast(Expr):
    expr: Expr
    type_name: str


@dataclass
class Case(Expr):
    whens: list[tuple[Expr, Expr]]
    else_expr: Expr | None = None


@dataclass
class IntervalLit(Expr):
    text: str  # e.g. "1 minute"


@dataclass
class Subquery(Expr):
    """A nested SELECT used as a scalar or IN-list source. Resolved
    (materialized) by the session before execution — the executors never
    see one (reference: DataFusion subquery decorrelation; here the
    observability dialect only needs uncorrelated subqueries)."""

    select: "Select"


@dataclass
class WindowCall(Expr):
    """`fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])`.

    Reference parity: the DataFusion window functions dashboards and the
    queryContext handler lean on (src/query/mod.rs:212-276 gives the
    reference the full window surface; src/handlers/http/query_context.rs
    pages rows around an anchor — expressible as a row_number window).
    Frames: only UNBOUNDED PRECEDING..CURRENT ROW — implicit (RANGE
    semantics when ORDER BY is present, whole partition otherwise) or
    explicit. `frame` is "cumulative" (RANGE: peers share the frame) |
    "rows_cumulative" (ROWS: each row ends its own frame) | None
    (default-by-order-presence).
    """

    name: str  # lowercase function name
    args: list[Expr]
    partition_by: list[Expr] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    frame: str | None = None


@dataclass
class Join:
    table: str
    alias: str | None
    kind: str  # "inner" | "left" | "cross"
    on: Expr | None


@dataclass
class SelectItem:
    expr: Expr
    alias: str | None = None


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False


@dataclass
class Select:
    items: list[SelectItem]
    table: str | None = None
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    table_alias: str | None = None
    joins: list[Join] = field(default_factory=list)
    # UNION [ALL] branches: (is_all, branch); ORDER BY/LIMIT parsed after
    # the last branch are hoisted up here and apply to the union result
    set_ops: list[tuple[bool, "Select"]] = field(default_factory=list)
    # WITH name AS (...) bindings, in declaration order; later CTEs (and
    # the main body) may reference earlier ones
    ctes: dict[str, "Select"] = field(default_factory=dict)
    # EXPLAIN [ANALYZE] prefix: None | "plan" | "analyze" (top level only)
    explain: str | None = None


def format_statement(sel: "Select") -> str:
    """Indented logical-plan rendering for EXPLAIN (shape follows
    DataFusion's logical plan display the reference exposes through its
    EXPLAIN support, src/query/mod.rs:212-276)."""
    lines: list[str] = []

    def emit(depth: int, text: str) -> None:
        lines.append("  " * depth + text)

    def fmt(s: "Select", depth: int) -> None:
        for name, sub in s.ctes.items():
            emit(depth, f"CTE: {name}")
            fmt(sub, depth + 1)
        if s.set_ops:
            # hoisted ORDER BY/LIMIT apply to the union result: render
            # them ABOVE the Union node
            if s.limit is not None or s.offset:
                emit(depth, f"Limit: {s.limit}" + (f" OFFSET {s.offset}" if s.offset else ""))
                depth += 1
            if s.order_by:
                keys = ", ".join(
                    expr_name(o.expr) + (" DESC" if o.desc else " ASC")
                    for o in s.order_by
                )
                emit(depth, f"Sort: {keys}")
                depth += 1
            emit(depth, "Union" + ("" if all(a for a, _ in s.set_ops) else " (distinct fold)"))
            base = _strip_set_ops(s)
            fmt(base, depth + 1)
            for _, branch in s.set_ops:
                fmt(branch, depth + 1)
            return
        if s.limit is not None or s.offset:
            lim = f"Limit: {s.limit}" + (f" OFFSET {s.offset}" if s.offset else "")
            emit(depth, lim)
            depth += 1
        if s.order_by:
            keys = ", ".join(
                expr_name(o.expr) + (" DESC" if o.desc else " ASC") for o in s.order_by
            )
            emit(depth, f"Sort: {keys}")
            depth += 1
        proj = ", ".join(
            expr_name(i.expr) + (f" AS {i.alias}" if i.alias else "") for i in s.items
        )
        emit(depth, ("Distinct " if s.distinct else "") + f"Projection: {proj}")
        depth += 1
        # HAVING filters the aggregate's OUTPUT: deeper means earlier, so
        # it renders above Aggregate (DataFusion order)
        if s.having is not None:
            emit(depth, f"Having: {expr_name(s.having)}")
            depth += 1
        if s.group_by:
            emit(
                depth,
                f"Aggregate: groupBy=[{', '.join(expr_name(g) for g in s.group_by)}]",
            )
            depth += 1
        if s.where is not None:
            emit(depth, f"Filter: {expr_name(s.where)}")
            depth += 1
        scan = f"TableScan: {s.table}" + (f" AS {s.table_alias}" if s.table_alias else "")
        emit(depth, scan)
        for j in s.joins:
            emit(
                depth + 1,
                f"Join[{j.kind}]: {j.table}"
                + (f" AS {j.alias}" if j.alias else "")
                + (f" ON {expr_name(j.on)}" if j.on is not None else ""),
            )

    def _strip_set_ops(s: "Select") -> "Select":
        import copy

        out = copy.copy(s)
        out.set_ops = []
        out.ctes = {}
        out.order_by = []
        out.limit = None
        out.offset = None
        return out

    fmt(sel, 0)
    return "\n".join(lines)


def contains_subquery(e: Expr | None) -> bool:
    if e is None:
        return False
    if isinstance(e, Subquery):
        return True
    if isinstance(e, BinaryOp):
        return contains_subquery(e.left) or contains_subquery(e.right)
    if isinstance(e, UnaryOp):
        return contains_subquery(e.operand)
    if isinstance(e, InList):
        return contains_subquery(e.expr) or any(contains_subquery(i) for i in e.items)
    if isinstance(e, Between):
        return any(contains_subquery(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, IsNull):
        return contains_subquery(e.expr)
    if isinstance(e, FunctionCall):
        return any(contains_subquery(a) for a in e.args)
    if isinstance(e, Cast):
        return contains_subquery(e.expr)
    if isinstance(e, Case):
        return any(contains_subquery(w) or contains_subquery(t) for w, t in e.whens) or contains_subquery(e.else_expr)
    if isinstance(e, WindowCall):
        return (
            any(contains_subquery(a) for a in e.args)
            or any(contains_subquery(p) for p in e.partition_by)
            or any(contains_subquery(o.expr) for o in e.order_by)
        )
    return False


AGGREGATE_FUNCS = {
    "count", "sum", "min", "max", "avg", "approx_distinct", "count_distinct",
    "stddev", "var", "approx_percentile_cont", "approx_median",
}

# pure window functions (aggregate names also work windowed: sum(...) OVER)
WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
    "first_value", "last_value",
}


def contains_window(e: Expr | None) -> bool:
    if e is None:
        return False
    if isinstance(e, WindowCall):
        return True
    if isinstance(e, BinaryOp):
        return contains_window(e.left) or contains_window(e.right)
    if isinstance(e, UnaryOp):
        return contains_window(e.operand)
    if isinstance(e, InList):
        return contains_window(e.expr) or any(contains_window(i) for i in e.items)
    if isinstance(e, Between):
        return any(contains_window(x) for x in (e.expr, e.low, e.high))
    if isinstance(e, IsNull):
        return contains_window(e.expr)
    if isinstance(e, FunctionCall):
        return any(contains_window(a) for a in e.args)
    if isinstance(e, Cast):
        return contains_window(e.expr)
    if isinstance(e, Case):
        return any(contains_window(w) or contains_window(t) for w, t in e.whens) or contains_window(
            e.else_expr
        )
    return False


def is_aggregate(e: Expr) -> bool:
    if isinstance(e, WindowCall):
        # a window call is NOT itself an aggregate — but its inputs may be
        # (`rank() OVER (ORDER BY sum(b))` in a GROUP BY query runs over
        # the aggregated output)
        return (
            any(is_aggregate(a) for a in e.args)
            or any(is_aggregate(p) for p in e.partition_by)
            or any(is_aggregate(o.expr) for o in e.order_by)
        )
    if isinstance(e, FunctionCall):
        if e.name in AGGREGATE_FUNCS:
            return True
        return any(is_aggregate(a) for a in e.args)
    if isinstance(e, BinaryOp):
        return is_aggregate(e.left) or is_aggregate(e.right)
    if isinstance(e, UnaryOp):
        return is_aggregate(e.operand)
    if isinstance(e, Cast):
        return is_aggregate(e.expr)
    if isinstance(e, Case):
        return any(is_aggregate(w) or is_aggregate(t) for w, t in e.whens) or (
            e.else_expr is not None and is_aggregate(e.else_expr)
        )
    return False


# -------------------------------------------------------------------- parser


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers -------------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> str | None:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            self.i += 1
            return t.value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlError(f"expected {kw.upper()} near position {self.peek().pos}")

    def accept_op(self, *ops: str) -> str | None:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            self.i += 1
            return t.value
        return None

    def accept_word(self, *words: str) -> str | None:
        """Contextual (non-reserved) word match, e.g. JOIN inside FROM."""
        t = self.peek()
        if t.kind == "ident" and t.value.lower() in words:
            self.i += 1
            return t.value.lower()
        return None

    def peek_word(self) -> str | None:
        t = self.peek()
        return t.value.lower() if t.kind == "ident" else None

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            raise SqlError(f"expected {word.upper()} near position {self.peek().pos}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r} near position {self.peek().pos}, got {self.peek().value!r}")

    # -- entry ---------------------------------------------------------------
    def parse(self) -> Select:
        # EXPLAIN [ANALYZE] prefix ("explain" is contextual: a column named
        # explain keeps working everywhere else)
        explain: str | None = None
        if self.peek().kind == "ident" and self.peek().value.lower() == "explain":
            self.next()
            explain = "plan"
            if self.peek().kind == "ident" and self.peek().value.lower() == "analyze":
                self.next()
                explain = "analyze"
        # WITH name AS (SELECT ...)[, ...] — CTEs bind for the whole
        # statement; "with" is contextual (a column named "with" stays a
        # column everywhere else)
        ctes: dict[str, Select] = {}
        if self.peek().kind == "ident" and self.peek().value.lower() == "with":
            self.next()
            while True:
                name_t = self.next()
                if name_t.kind != "ident":
                    raise SqlError(f"expected CTE name at {name_t.pos}")
                self.expect_kw("as")
                self.expect_op("(")
                sub = self._parse_set_expr()
                self.expect_op(")")
                if name_t.value in ctes:
                    raise SqlError(f"duplicate CTE name {name_t.value!r}")
                ctes[name_t.value] = sub
                if not self.accept_op(","):
                    break
        sel = self._parse_set_expr()
        sel.ctes = ctes
        sel.explain = explain
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SqlError(f"trailing tokens at {self.peek().pos}")
        return sel

    def _parse_set_expr(self) -> Select:
        """SELECT ... [UNION [ALL] SELECT ...]*; trailing ORDER BY / LIMIT
        bind to the whole union (standard SQL: branches can't carry them)."""
        self.expect_kw("select")
        first = self.parse_select_body()
        branches: list[tuple[bool, Select]] = []
        while self.peek().kind == "ident" and self.peek().value.lower() == "union":
            self.next()
            is_all = bool(self.accept_word("all"))
            self.expect_kw("select")
            branches.append((is_all, self.parse_select_body()))
        if branches:
            if first.order_by or first.limit is not None:
                raise SqlError("ORDER BY/LIMIT before UNION is not supported")
            for _, b in branches[:-1]:
                if b.order_by or b.limit is not None:
                    raise SqlError("ORDER BY/LIMIT inside a UNION branch is not supported")
            # the trailing ORDER BY/LIMIT parsed into the last branch apply
            # to the union result: hoist them to the head select
            last = branches[-1][1]
            first.order_by, last.order_by = last.order_by, []
            first.limit, last.limit = last.limit, None
            first.offset, last.offset = last.offset, None
            first.set_ops = branches
        return first

    def parse_select_body(self) -> Select:
        distinct = bool(self.accept_kw("distinct"))
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        table = table_alias = None
        joins: list[Join] = []
        if self.accept_kw("from"):
            table, table_alias = self.parse_table_ref()
            while True:
                kind = None
                nxt = self.peek_word()
                after = (
                    self.tokens[self.i + 1]
                    if self.i + 1 < len(self.tokens)
                    else self.tokens[-1]
                )
                after_word = after.value.lower() if after.kind == "ident" else None
                if nxt == "cross" and after_word == "join":
                    self.next()
                    self.next()
                    kind = "cross"
                elif nxt == "inner" and after_word == "join":
                    self.next()
                    self.next()
                    kind = "inner"
                elif nxt == "left":
                    self.next()
                    self.accept_word("outer")
                    self.expect_word("join")
                    kind = "left"
                elif nxt == "join":
                    self.next()
                    kind = "inner"
                elif nxt in ("right", "full") and after_word in ("join", "outer"):
                    raise SqlError("RIGHT/FULL joins are not supported; rewrite as LEFT")
                if kind is None:
                    break
                jt, ja = self.parse_table_ref()
                on = None
                if kind != "cross":
                    self.expect_word("on")
                    on = self.parse_expr()
                joins.append(Join(jt, ja, kind, on))
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        group_by: list[Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())
        having = None
        if self.accept_kw("having"):
            having = self.parse_expr()
        order_by: list[OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = offset = None
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "number":
                raise SqlError(f"expected LIMIT count at {t.pos}")
            limit = int(t.value)
        if self.accept_kw("offset"):
            t = self.next()
            if t.kind != "number":
                raise SqlError(f"expected OFFSET count at {t.pos}")
            offset = int(t.value)
        return Select(
            items=items,
            table=table,
            where=where,
            group_by=group_by,
            having=having,
            order_by=order_by,
            limit=limit,
            offset=offset,
            distinct=distinct,
            table_alias=table_alias,
            joins=joins,
        )

    def parse_table_ref(self) -> tuple[str, str | None]:
        t = self.next()
        if t.kind != "ident":
            raise SqlError(f"expected table name at {t.pos}")
        alias = None
        if self.accept_kw("as"):
            a = self.next()
            if a.kind != "ident":
                raise SqlError(f"expected alias at {a.pos}")
            alias = a.value
        elif self.peek().kind == "ident" and self.peek().value.lower() not in NON_ALIAS_WORDS:
            alias = self.next().value
        return t.value, alias

    def parse_select_item(self) -> SelectItem:
        if self.accept_op("*"):
            return SelectItem(Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            t = self.next()
            if t.kind not in ("ident", "string"):
                raise SqlError(f"expected alias at {t.pos}")
            alias = t.value
        elif self.peek().kind == "ident" and self.peek().value.lower() != "union":
            alias = self.next().value
        return SelectItem(e, alias)

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        elif self.accept_kw("asc"):
            desc = False
        return OrderItem(e, desc)

    # -- expressions (precedence climbing) ----------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        negated = bool(self.accept_kw("not"))
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.peek().kind == "kw" and self.peek().value == "select":
                self.next()
                sub = self.parse_select_body()
                self.expect_op(")")
                return InList(left, [Subquery(sub)], negated)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return InList(left, items, negated)
        if self.accept_kw("between"):
            low = self.parse_additive()
            self.expect_kw("and")
            high = self.parse_additive()
            return Between(left, low, high, negated)
        if self.accept_kw("like"):
            return BinaryOp("not_like" if negated else "like", left, self.parse_additive())
        if self.accept_kw("ilike"):
            return BinaryOp("not_ilike" if negated else "ilike", left, self.parse_additive())
        if negated:
            raise SqlError(f"unexpected NOT at {self.peek().pos}")
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return IsNull(left, neg)
        op = self.accept_op("=", "!=", "<", "<=", ">", ">=")
        if op:
            return BinaryOp(op, left, self.parse_additive())
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-", "||")
            if not op:
                return left
            left = BinaryOp(op, left, self.parse_multiplicative())

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return left
            left = BinaryOp(op, left, self.parse_unary())

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            return UnaryOp("-", self.parse_unary())
        self.accept_op("+")
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            return Literal(t.value)
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind == "kw":
            if t.value == "null":
                self.next()
                return Literal(None)
            if t.value == "true":
                self.next()
                return Literal(True)
            if t.value == "false":
                self.next()
                return Literal(False)
            if t.value == "interval":
                self.next()
                lit = self.next()
                if lit.kind != "string":
                    raise SqlError(f"expected interval string at {lit.pos}")
                return IntervalLit(lit.value)
            if t.value == "case":
                return self.parse_case()
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                ty = self.next()
                if ty.kind not in ("ident", "kw"):
                    raise SqlError(f"expected type name at {ty.pos}")
                type_name = str(ty.value).lower()
                # types like timestamp(3) / varchar(10)
                if self.accept_op("("):
                    while not self.accept_op(")"):
                        self.next()
                self.expect_op(")")
                return Cast(e, type_name)
            if t.value == "distinct":
                # inside count(DISTINCT x) handled in function parse; bare =error
                raise SqlError(f"unexpected DISTINCT at {t.pos}")
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "kw" and self.peek().value == "select":
                self.next()
                sub = self.parse_select_body()
                self.expect_op(")")
                return Subquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.value == "*":
            self.next()
            return Star()
        if t.kind == "ident":
            self.next()
            name = t.value
            if self.accept_op("("):
                return self.parse_function(name)
            if self.accept_op("."):
                col = self.next()
                if col.kind == "op" and col.value == "*":
                    return Star(table=name)
                if col.kind != "ident":
                    raise SqlError(f"expected column after '.' at {col.pos}")
                return Column(col.value, table=name)
            return Column(name)
        raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

    def parse_function(self, name: str) -> Expr:
        lname = name.lower()
        distinct = bool(self.accept_kw("distinct"))
        args: list[Expr] = []
        if not self.accept_op(")"):
            if self.accept_op("*"):
                args.append(Star())
            else:
                args.append(self.parse_expr())
            while self.accept_op(","):
                if self.accept_op("*"):
                    args.append(Star())
                else:
                    args.append(self.parse_expr())
            self.expect_op(")")
        if self.peek().kind == "ident" and self.peek().value.lower() == "over":
            self.next()
            if distinct:
                raise SqlError("DISTINCT window aggregates are not supported")
            return self.parse_over(lname, args)
        if lname == "count" and distinct:
            return FunctionCall("count_distinct", args)
        return FunctionCall(lname, args, distinct)

    def parse_over(self, fname: str, args: list[Expr]) -> Expr:
        """OVER ([PARTITION BY ...] [ORDER BY ...] [frame]) — frames beyond
        the SQL defaults are rejected (DataFusion-default parity)."""
        if fname not in WINDOW_FUNCS and fname not in AGGREGATE_FUNCS:
            raise SqlError(f"{fname}() cannot be used as a window function")
        self.expect_op("(")
        partition_by: list[Expr] = []
        order_by: list[OrderItem] = []
        frame: str | None = None
        if self.accept_word("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.accept_op(","):
                partition_by.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        unit = self.accept_word("rows", "range")
        if unit:
            # only the UNBOUNDED PRECEDING..CURRENT ROW frames are
            # expressible; ROWS and RANGE differ on tied order keys (peers
            # share the frame under RANGE, not under ROWS)
            self.expect_kw("between")
            self.expect_word("unbounded")
            self.expect_word("preceding")
            self.expect_kw("and")
            self.expect_word("current")
            self.expect_word("row")
            frame = "rows_cumulative" if unit == "rows" else "cumulative"
        self.expect_op(")")
        return WindowCall(fname, args, partition_by, order_by, frame)

    def parse_case(self) -> Expr:
        self.expect_kw("case")
        whens: list[tuple[Expr, Expr]] = []
        base: Expr | None = None
        if not (self.peek().kind == "kw" and self.peek().value == "when"):
            base = self.parse_expr()
        while self.accept_kw("when"):
            cond = self.parse_expr()
            if base is not None:
                cond = BinaryOp("=", base, cond)
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        else_expr = None
        if self.accept_kw("else"):
            else_expr = self.parse_expr()
        self.expect_kw("end")
        return Case(whens, else_expr)


def parse_sql(sql: str) -> Select:
    return Parser(sql).parse()


def expr_name(e: Expr) -> str:
    """Display name for an unaliased select expression."""
    if isinstance(e, Column):
        return e.name
    if isinstance(e, Star):
        return "*"
    if isinstance(e, FunctionCall):
        if e.name == "count" and e.args and isinstance(e.args[0], Star):
            return "count(*)"
        return f"{e.name}({','.join(expr_name(a) for a in e.args)})"
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, BinaryOp):
        return f"{expr_name(e.left)} {e.op} {expr_name(e.right)}"
    if isinstance(e, Cast):
        return expr_name(e.expr)
    if isinstance(e, IntervalLit):
        return f"interval '{e.text}'"
    if isinstance(e, WindowCall):
        return f"{e.name}({','.join(expr_name(a) for a in e.args)}) over"
    return e.__class__.__name__.lower()
