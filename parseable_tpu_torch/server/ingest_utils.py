"""Ingest dispatch: flatten JSON and push it into staging.

Counterpart of `parseable_tpu/server/ingest_utils.py` (reference:
handlers/http/modal/utils/ingest_utils.rs), trimmed to plain JSON. A raw
body walks a three-tier ladder, each tier declining to the next on shapes
it cannot represent exactly, so every tier stages the same table:

1. columnar — the native library parses and flattens the body in one pass
   into Arrow-layout buffers (sharded over its worker pool, GIL released),
   imported zero-copy, normalized by `fast_columns_from_table` and written
   direct to the staging IPC file;
2. NDJSON — the native library flattens to NDJSON and pyarrow's JSON
   reader builds the columns;
3. Python — `json.loads`, the depth guard, generic (cross-product)
   flattening and `flatten`, then `push_logs` chunks records per partition
   value and builds and processes events.

`lane_stats()` counts requests by lane and result. OTel, Kinesis and
known-format extraction are later slices; those log sources are refused
with an `IngestError`.
"""

from __future__ import annotations

import json
import threading
from datetime import UTC, datetime
from typing import Any

import pyarrow as pa
import pyarrow.json as pj

from parseable_tpu_torch import native
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.event import Event
from parseable_tpu_torch.event.format import LogSource, SchemaVersion, fast_columns_from_table
from parseable_tpu_torch.event.json_format import JsonEvent
from parseable_tpu_torch.utils.arrowutil import add_parseable_fields
from parseable_tpu_torch.utils.flatten import (
    JsonFlattenError,
    flatten,
    generic_flattening,
    has_more_than_max_allowed_levels,
)


class IngestError(ValueError):
    pass


def flatten_json_records(
    payload: Any,
    max_flatten_level: int,
    time_partition: str | None,
    time_partition_limit_days: int | None,
    custom_partition: str | None,
    max_chunk_age_hours: int,
) -> list[dict[str, Any]]:
    """Plain-JSON path: depth guard -> cross-product expansion -> flatten."""
    if has_more_than_max_allowed_levels(payload, max_flatten_level):
        raise IngestError(f"JSON is deeper than the allowed {max_flatten_level} levels")
    expanded = generic_flattening(payload)
    rows: list[dict[str, Any]] = []
    validation = time_partition is not None or custom_partition is not None
    for item in expanded:
        try:
            flat = flatten(
                item,
                "_",
                time_partition,
                time_partition_limit_days,
                custom_partition,
                validation_required=validation,
                max_chunk_age_hours=max_chunk_age_hours,
            )
        except JsonFlattenError as e:
            raise IngestError(str(e)) from e
        if isinstance(flat, list):
            rows.extend(flat)
        else:
            rows.append(flat)
    return rows


def _parse_payload(payload: Any, raw_body: bytes | None) -> Any:
    if payload is not None or raw_body is None:
        return payload
    try:
        return json.loads(raw_body)
    except json.JSONDecodeError as e:
        raise IngestError(f"invalid JSON: {e}") from e


LANES = ("columnar", "ndjson", "python")
RESULTS = ("hit", "declined")
_lane_lock = threading.Lock()
_lane_counts = {(lane, result): 0 for lane in LANES for result in RESULTS}


def _lane_result(lane: str, result: str) -> None:
    """Count one request by the lane that served it: a native tier's "hit",
    "python"/"declined" after the native tiers declined it, "python"/"hit"
    when none was asked (no raw body)."""
    with _lane_lock:
        _lane_counts[(lane, result)] += 1


def lane_stats() -> dict[str, dict[str, int]]:
    """{lane: {result: requests}} since the last `reset_lane_stats`."""
    with _lane_lock:
        return {lane: {r: _lane_counts[(lane, r)] for r in RESULTS} for lane in LANES}


def reset_lane_stats() -> None:
    with _lane_lock:
        for key in _lane_counts:
            _lane_counts[key] = 0


def flatten_and_push_logs(
    p: Parseable,
    stream_name: str,
    payload: Any,
    log_source: LogSource,
    custom_fields: dict[str, str] | None = None,
    origin_size: int = 0,
    log_source_name: str | None = None,
    raw_body: bytes | None = None,
) -> int:
    """Flatten plain JSON and push it into staging. Returns the row count.

    With `raw_body` (the undecoded HTTP payload) the native tiers go first;
    `payload` may then be None — it is parsed only if they decline."""
    plain_json = log_source == LogSource.JSON or (
        log_source == LogSource.CUSTOM and not log_source_name
    )
    if not plain_json:
        raise IngestError(
            f"log source {log_source_name or log_source.value!r} is not supported by this "
            "server yet; send plain JSON"
        )
    if raw_body is not None:
        lane_out: dict = {}
        count = ingest_native_fast(p, stream_name, raw_body, log_source, custom_fields, lane_out)
        if count is not None:
            _lane_result(lane_out["lane"], "hit")
            return count
        _lane_result("python", "declined")
    else:
        _lane_result("python", "hit")
    meta = p.get_stream(stream_name).metadata
    rows = flatten_json_records(
        _parse_payload(payload, raw_body),
        p.options.event_flatten_level,
        meta.time_partition,
        meta.time_partition_limit_days,
        meta.custom_partition,
        p.options.event_max_chunk_age,
    )
    if not rows:
        return 0
    field_count = len({k for r in rows for k in r})
    if field_count > p.options.dataset_fields_allowed_limit:
        raise IngestError(
            f"fields ({field_count}) exceed dataset limit "
            f"({p.options.dataset_fields_allowed_limit})"
        )
    return push_logs(p, stream_name, rows, log_source, custom_fields, origin_size)


def ingest_native_fast(
    p: Parseable,
    stream_name: str,
    raw_body: bytes,
    log_source: LogSource,
    custom_fields: dict[str, str] | None,
    lane_out: dict | None = None,
) -> int | None:
    """The native tiers of the ladder: columnar, then NDJSON. Returns the
    row count, or None whenever a stage prefers the exact Python semantics
    (arrays, sparse/duplicate keys, depth, mixed types, partial timestamp
    parses, partitioned or static streams, malformed JSON) — every decline
    falls through with identical results. `lane_out` receives
    {"lane": "columnar"|"ndjson"} on a hit."""
    stream = p.get_stream(stream_name)
    if not _native_lane_eligible(stream.metadata):
        return None
    # C++ depth N == Python level N+1 (scalars sit one level below the
    # deepest dict), so the native limit is event_flatten_level - 1 exactly
    depth = p.options.event_flatten_level - 1
    r = native.flatten_columnar(raw_body, depth)
    if r is not None:
        names, arrays, nrows = r
        count = 0 if nrows == 0 else _columns_to_event(
            p, stream, names, arrays, len(raw_body), log_source, custom_fields
        )
        # a normalization decline goes to the Python lane: the NDJSON tier
        # would assemble the same columns and decline identically
        if count is not None and lane_out is not None:
            lane_out["lane"] = "columnar"
        return count
    r = native.flatten_ndjson(raw_body, depth)
    if r is None:
        return None
    ndjson, nrows = r
    count = 0 if nrows == 0 else _ndjson_to_event(
        p, stream, ndjson, len(raw_body), log_source, custom_fields
    )
    if count is not None and lane_out is not None:
        lane_out["lane"] = "ndjson"
    return count


def _native_lane_eligible(meta) -> bool:
    return (
        meta.time_partition is None
        and meta.custom_partition is None
        and not meta.static_schema_flag
        and meta.schema_version == SchemaVersion.V1
    )


def _columns_to_event(
    p: Parseable,
    stream,
    names: list[str],
    arrays: list[pa.Array],
    origin_size: int,
    log_source: LogSource,
    custom_fields: dict[str, str] | None,
) -> int | None:
    """Columnar tier's tail: the natively built arrays (zero-copy) assemble
    straight into a table for the shared normalization. They are single
    contiguous buffers, so the staged batch streams direct into the bucket's
    IPC file."""
    tbl = pa.Table.from_arrays(arrays, names=names)
    return _table_to_event(p, stream, tbl, origin_size, log_source, custom_fields, direct=True)


def _ndjson_to_event(
    p: Parseable,
    stream,
    ndjson: bytes,
    origin_size: int,
    log_source: LogSource,
    custom_fields: dict[str, str] | None,
) -> int | None:
    """NDJSON tier's tail: pyarrow's JSON reader builds the columns from the
    natively flattened NDJSON. None when the reader prefers the exact
    Python path."""
    try:
        # BufferReader wraps the bytes zero-copy (BytesIO copies them)
        tbl = pj.read_json(pa.BufferReader(ndjson))
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return None  # reader-level type conflict: the Python lane decides
    return _table_to_event(p, stream, tbl, origin_size, log_source, custom_fields)


def _table_to_event(
    p: Parseable,
    stream,
    tbl: pa.Table,
    origin_size: int,
    log_source: LogSource,
    custom_fields: dict[str, str] | None,
    direct: bool = False,
) -> int | None:
    """Shared tail of both native tiers: `fast_columns_from_table` types the
    columns, then the event goes through the unchanged schema commit and
    staging. None when the normalizer prefers the exact Python path."""
    meta = stream.metadata
    if len(tbl.column_names) > p.options.dataset_fields_allowed_limit:
        raise IngestError(
            f"fields ({len(tbl.column_names)}) exceed dataset limit "
            f"({p.options.dataset_fields_allowed_limit})"
        )
    fast = fast_columns_from_table(tbl, meta.schema or None, meta.infer_timestamp)
    if fast is None:
        return None
    batch, _schema = fast
    now = datetime.now(UTC)
    batch = add_parseable_fields(batch, now, custom_fields or {})
    ev = Event(
        stream_name=stream.name,
        rb=batch,
        origin_format="json",
        origin_size=origin_size,
        is_first_event=not meta.schema,
        parsed_timestamp=now,
        stream_type=meta.stream_type,
        log_source=log_source,
        direct_staging=direct,
    )
    ev.process(stream, commit_schema=p.commit_schema)
    return batch.num_rows


def push_logs(
    p: Parseable,
    stream_name: str,
    rows: list[dict[str, Any]],
    log_source: LogSource,
    custom_fields: dict[str, str] | None = None,
    origin_size: int = 0,
) -> int:
    """Chunk rows by custom-partition value and process each chunk
    (reference: ingest_utils.rs:291)."""
    stream = p.get_stream(stream_name)
    meta = stream.metadata
    chunks: list[list[dict]]
    if meta.custom_partition:
        first_key = meta.custom_partition.split(",")[0].strip()
        grouped: dict[Any, list[dict]] = {}
        for r in rows:
            grouped.setdefault(r.get(first_key), []).append(r)
        chunks = list(grouped.values())
    elif meta.time_partition:
        chunks = [[r] for r in rows]  # per-record parsed timestamps
    else:
        chunks = [rows]
    total = 0
    # origin_size pro-rated by chunk rows (cumulative rounding, so the
    # per-chunk sizes always sum to exactly the payload size)
    total_rows = len(rows) or 1
    seen_rows = 0
    allocated = 0
    for chunk in chunks:
        seen_rows += len(chunk)
        chunk_size = origin_size * seen_rows // total_rows - allocated
        allocated += chunk_size
        ev = JsonEvent(
            chunk,
            stream_name,
            origin_size=chunk_size,
            log_source=log_source,
            custom_fields=custom_fields or {},
        ).into_event(meta, stream.metadata.stream_type)
        ev.process(stream, commit_schema=p.commit_schema)
        total += ev.rb.num_rows
    return total
