"""Arrow batch utilities (counterpart of `parseable_tpu/utils/arrowutil.py`;
reference: src/utils/arrow/):

- `adapt_batch`      — project a batch onto a wider table schema, null-filling
                       missing columns (batch_adapter.rs:33).
- `add_parseable_fields` — prepend the `p_timestamp` column plus any custom
                       `x-p-*` header-derived constant columns (mod.rs:99-150).
- `record_batches_to_json` — row-major JSON for query responses (mod.rs:50).
- `reverse`          — reverse row order of a batch (mod.rs:152).
- `merge_schemas`    — union of fields by name.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any

import numpy as np
import pyarrow as pa

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY


def adapt_batch(table_schema: pa.Schema, batch: pa.RecordBatch) -> pa.RecordBatch:
    """Project `batch` onto `table_schema`, filling missing columns with nulls."""
    arrays = []
    for f in table_schema:
        idx = batch.schema.get_field_index(f.name)
        if idx >= 0:
            col = batch.column(idx)
            if col.type != f.type:
                col = col.cast(f.type, safe=False)
            arrays.append(col)
        else:
            arrays.append(pa.nulls(batch.num_rows, type=f.type))
    return pa.RecordBatch.from_arrays(arrays, schema=table_schema)


def add_parseable_fields(
    batch: pa.RecordBatch,
    p_timestamp: datetime,
    custom_fields: dict[str, str] | None = None,
) -> pa.RecordBatch:
    """Prepend p_timestamp + constant custom columns (sorted by name)."""
    n = batch.num_rows
    names: list[str] = [DEFAULT_TIMESTAMP_KEY]
    ts_ms = np.int64(p_timestamp.timestamp() * 1000)
    arrays: list[pa.Array] = [
        pa.array(np.full(n, ts_ms, dtype="datetime64[ms]"), type=pa.timestamp("ms"))
    ]
    for key in sorted(custom_fields or {}):
        if key == DEFAULT_TIMESTAMP_KEY:
            continue
        names.append(key)
        arrays.append(pa.array([custom_fields[key]] * n, type=pa.string()))
    existing_names = set(batch.schema.names)
    fields = [pa.field(names[0], pa.timestamp("ms"))]
    fields += [pa.field(nm, pa.string()) for nm in names[1:]]
    out_fields, out_arrays = [], []
    for f, a in zip(fields, arrays):
        if f.name not in existing_names:
            out_fields.append(f)
            out_arrays.append(a)
    for i, f in enumerate(batch.schema):
        out_fields.append(f)
        out_arrays.append(batch.column(i))
    return pa.RecordBatch.from_arrays(out_arrays, schema=pa.schema(out_fields))


def reverse(batch: pa.RecordBatch) -> pa.RecordBatch:
    idx = pa.array(range(batch.num_rows - 1, -1, -1), type=pa.int64())
    return batch.take(idx)


def _json_value(v: Any) -> Any:
    if isinstance(v, datetime):
        # RFC3339 with millisecond precision, matching arrow-json output
        return v.isoformat(timespec="milliseconds")
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return v


def record_batches_to_json(batches: list[pa.RecordBatch]) -> list[dict[str, Any]]:
    rows: list[dict[str, Any]] = []
    for batch in batches:
        cols = {name: batch.column(i).to_pylist() for i, name in enumerate(batch.schema.names)}
        for r in range(batch.num_rows):
            rows.append({name: _json_value(col[r]) for name, col in cols.items()})
    return rows


def merge_schemas(schemas: list[pa.Schema]) -> pa.Schema:
    """Union of fields by name; first-seen type wins unless widened to string."""
    out: dict[str, pa.Field] = {}
    for s in schemas:
        for f in s:
            prev = out.get(f.name)
            if prev is None:
                out[f.name] = f
            elif prev.type != f.type:
                # widen numerics to float64, otherwise fall back to string
                if pa.types.is_floating(f.type) and pa.types.is_integer(prev.type):
                    out[f.name] = f
                elif pa.types.is_floating(prev.type) and pa.types.is_integer(f.type):
                    pass
                else:
                    out[f.name] = pa.field(f.name, pa.string())
    return pa.schema(sorted(out.values(), key=lambda f: f.name))
