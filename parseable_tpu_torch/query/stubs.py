"""Source ids and stubs of lake blocks, shared by the scan and the engine.

Counterpart of `parseable_tpu/query/executor_tpu.py`'s `STUB_META`,
`dict_group_columns`, `hot_key`, `is_stub` and `make_stub` (:88, :113-139).
Each lake table the scan yields carries its source id (`path|size|rows`)
in its schema metadata. A block the device hot set holds, or the
encoded-block cache can serve, is yielded as a zero-column stub instead
(query/provider.py), which the GPU executor resolves from its tiers
(query/executor_cuda.py).
"""

from __future__ import annotations

import pyarrow as pa

from parseable_tpu_torch.ops.device import f64_name
from parseable_tpu_torch.query import sql as S

SOURCE_ID_META = b"ptpu_source_id"
STUB_META = b"ptpu_hot_stub"


def dict_group_columns(select: S.Select) -> set[str]:
    """Group-by columns that device-encode as dictionaries (plain columns)."""
    out = set()
    for g in select.group_by:
        e = g.expr if isinstance(g, S.Cast) else g
        if isinstance(e, S.Column):
            out.add(e.name)
    return out


def f64_columns(where: S.Expr | None) -> set[str]:
    """Columns the WHERE compares with a number (=, <, ..., BETWEEN, IN):
    the GPU engine asks for their f64 copies (`ops/device.py f64_name`),
    which a column exact in f32 does without."""
    out: set[str] = set()

    def column(e: S.Expr) -> str | None:
        e = e.expr if isinstance(e, S.Cast) else e
        return e.name if isinstance(e, S.Column) else None

    def number(e: S.Expr) -> bool:
        e = e.expr if isinstance(e, S.Cast) else e
        return isinstance(e, S.Literal) and isinstance(e.value, (int, float)) and not isinstance(
            e.value, bool)

    def visit(e: S.Expr | None) -> None:
        if isinstance(e, S.BinaryOp):
            if e.op in ("and", "or"):
                visit(e.left)
                visit(e.right)
            elif e.op in ("=", "!=", "<", "<=", ">", ">="):
                for a, b in ((e.left, e.right), (e.right, e.left)):
                    if column(a) and number(b):
                        out.add(column(a))
        elif isinstance(e, S.UnaryOp):
            visit(e.operand)
        elif isinstance(e, S.Between):
            if column(e.expr) and (number(e.low) or number(e.high)):
                out.add(column(e.expr))
        elif isinstance(e, S.InList):
            if column(e.expr) and any(number(i) for i in e.items):
                out.add(column(e.expr))

    visit(where)
    return out


def device_columns(needed: set[str] | None, where: S.Expr | None) -> set[str] | None:
    """What the GPU engine encodes of a block: the columns it reads and the
    f64 copies its WHERE may compare; the hot set and the encoded-block
    cache key a block by this set."""
    if needed is None:
        return None
    return needed | {f64_name(c) for c in f64_columns(where)}


def hot_key(source_id: bytes, needed: set[str] | None, dict_cols: set[str]) -> tuple:
    """Hot-set key of a block: its source id and the column-set signature."""
    return (
        source_id,
        tuple(sorted(needed)) if needed is not None else None,
        tuple(sorted(dict_cols)),
    )


def is_stub(table: pa.Table) -> bool:
    return (table.schema.metadata or {}).get(STUB_META) is not None


def make_stub(source_id: bytes, num_rows: int) -> pa.Table:
    """Zero-column placeholder for a block the hot set or the encoded-block
    cache holds: the scan yields it instead of reading the Parquet file."""
    return pa.table({}).replace_schema_metadata(
        {SOURCE_ID_META: source_id, STUB_META: str(num_rows).encode()}
    )
