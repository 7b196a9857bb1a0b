"""Ingest dispatch: flatten JSON and push it into staging.

Counterpart of `parseable_tpu/server/ingest_utils.py` (reference:
handlers/http/modal/utils/ingest_utils.rs), trimmed to the Python lane:
plain JSON goes through the depth guard, generic (cross-product)
flattening and `flatten`, then `push_logs` chunks records per partition
value and builds and processes events. The JAX package's native lanes,
OTel, Kinesis and known-format extraction are later slices; those log
sources are refused with an `IngestError`.
"""

from __future__ import annotations

import json
from typing import Any

from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.event.format import LogSource
from parseable_tpu_torch.event.json_format import JsonEvent
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
    """Parse (from `raw_body` when `payload` is None) and flatten plain
    JSON, then push it into staging. Returns the row count."""
    plain_json = log_source == LogSource.JSON or (
        log_source == LogSource.CUSTOM and not log_source_name
    )
    if not plain_json:
        raise IngestError(
            f"log source {log_source_name or log_source.value!r} is not supported by this "
            "server yet; send plain JSON"
        )
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
