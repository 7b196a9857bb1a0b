"""Arrow schema utilities (counterpart of `parseable_tpu/utils/arrowutil.py`,
trimmed to what the query slice uses)."""

from __future__ import annotations

import pyarrow as pa


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
