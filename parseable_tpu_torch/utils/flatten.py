"""JSON flattening for schema-on-write ingest.

Counterpart of `parseable_tpu/utils/flatten.py`, the same behaviour
(reference: src/utils/json/flatten.rs):

- `flatten(value, separator)` collapses nested objects into dotted/underscored
  keys; arrays of objects become columnar arrays per key.
- `generic_flattening(value)` expands nested arrays into a cross-product of
  rows (one row per array-element combination).
- a configurable nesting-depth limit guards pathological documents.
- time/custom partition fields are validated before flattening.
"""

from __future__ import annotations

import threading
from datetime import UTC, datetime, timedelta
from typing import Any

from parseable_tpu_torch.utils.timeutil import parse_rfc3339


class JsonFlattenError(ValueError):
    pass


class CannotFlatten(JsonFlattenError):
    def __init__(self) -> None:
        super().__init__("Cannot flatten this JSON")


# First time-partition timestamp seen; later events must not be more than
# `event_max_chunk_age` hours older than it (reference: flatten.rs:33,219-244).
_reference_timestamp_lock = threading.Lock()
_reference_timestamp: datetime | None = None


def reset_reference_timestamp() -> None:
    global _reference_timestamp
    with _reference_timestamp_lock:
        _reference_timestamp = None


def validate_time_partition(
    obj: dict[str, Any],
    time_partition: str | None,
    time_partition_limit_days: int | None,
    max_chunk_age_hours: int = 24,
) -> None:
    if time_partition is None:
        return
    limit_days = time_partition_limit_days or 30
    if time_partition not in obj:
        raise JsonFlattenError(f"Ingestion failed as field {time_partition} is not part of the log")
    v = obj[time_partition]
    if not isinstance(v, str):
        raise JsonFlattenError(f"Ingestion failed as field {time_partition} is not a string")
    try:
        parsed = parse_rfc3339(v)
    except ValueError:
        raise JsonFlattenError(
            f"Field {time_partition} is not in the correct datetime format"
        ) from None

    global _reference_timestamp
    with _reference_timestamp_lock:
        if _reference_timestamp is None:
            cutoff = datetime.now(UTC) - timedelta(days=limit_days)
            if parsed < cutoff:
                raise JsonFlattenError(
                    f"Field {time_partition} value '{parsed}' is more than {limit_days} days old"
                )
            _reference_timestamp = parsed
        else:
            max_age_before_ref = _reference_timestamp - timedelta(hours=max_chunk_age_hours)
            if parsed < max_age_before_ref:
                raise JsonFlattenError(
                    f"Field {time_partition} timestamp '{parsed}' is more than "
                    f"{max_chunk_age_hours} hours older than reference timestamp "
                    f"'{_reference_timestamp}'"
                )


def validate_custom_partition(obj: dict[str, Any], custom_partition: str | None) -> None:
    """Custom partition fields must be present, scalar, and '.'-free."""
    if custom_partition is None:
        return
    for raw in custom_partition.split(","):
        name = raw.strip()
        if name not in obj:
            raise JsonFlattenError(f"Ingestion failed as field {name} is not part of the log")
        v = obj[name]
        if v is None or (isinstance(v, str) and v == ""):
            raise JsonFlattenError(f"Ingestion failed as field {name} is empty or 'null'")
        if isinstance(v, dict):
            raise JsonFlattenError(f"Ingestion failed as field {name} is an object")
        if isinstance(v, list):
            raise JsonFlattenError(f"Ingestion failed as field {name} is an array")
        if isinstance(v, str) and "." in v:
            raise JsonFlattenError(f"Ingestion failed as field {name} contains a period in the value")
        if isinstance(v, float) and not isinstance(v, bool):
            raise JsonFlattenError(f"Ingestion failed as field {name} contains a period in the value")


def _flatten_object(
    out: dict[str, Any], parent_key: str | None, obj: dict[str, Any], separator: str
) -> None:
    for key, value in obj.items():
        new_key = f"{parent_key}{separator}{key}" if parent_key is not None else key
        if isinstance(value, dict):
            _flatten_object(out, new_key, value, separator)
        elif isinstance(value, list) and any(isinstance(e, dict) for e in value):
            _flatten_array_objects(out, new_key, value, separator)
        else:
            out[new_key] = value


def _flatten_array_objects(
    out: dict[str, Any], parent_key: str, arr: list[Any], separator: str
) -> None:
    """Array of objects -> one array-valued column per flattened key."""
    columns: dict[str, list[Any]] = {}
    for index, value in enumerate(arr):
        if isinstance(value, dict):
            row: dict[str, Any] = {}
            _flatten_object(row, parent_key, value, separator)
            for key, v in row.items():
                columns.setdefault(key, [None] * index).append(v)
        elif value is None:
            for col in columns.values():
                col.append(None)
        else:
            raise JsonFlattenError("Found non-object element while flattening array of objects")
        for col in columns.values():
            while len(col) < index + 1:
                col.append(None)
    for key in sorted(columns):
        out[key] = columns[key]


def flatten(
    value: Any,
    separator: str = "_",
    time_partition: str | None = None,
    time_partition_limit_days: int | None = None,
    custom_partition: str | None = None,
    validation_required: bool = False,
    max_chunk_age_hours: int = 24,
) -> Any:
    """Flatten a JSON object (or top-level array of objects) in place-style.

    Returns the flattened value (dict, or list of dicts for a top-level array).
    """
    if isinstance(value, dict):
        if validation_required:
            validate_time_partition(
                value, time_partition, time_partition_limit_days, max_chunk_age_hours
            )
            validate_custom_partition(value, custom_partition)
        out: dict[str, Any] = {}
        _flatten_object(out, None, value, separator)
        return out
    if isinstance(value, list):
        return [
            flatten(
                v,
                separator,
                time_partition,
                time_partition_limit_days,
                custom_partition,
                validation_required,
                max_chunk_age_hours,
            )
            for v in value
        ]
    raise CannotFlatten()


def generic_flattening(value: Any) -> list[Any]:
    """Expand nested arrays into a cross-product of rows.

    `{"a": [{"b": 1}, {"c": 2}], "d": {"e": 4}}` ->
    `[{"a": {"b": 1}, "d": {"e": 4}}, {"a": {"c": 2}, "d": {"e": 4}}]`
    """
    if isinstance(value, list):
        rows: list[Any] = []
        for item in value:
            rows.extend(generic_flattening(item))
        return rows
    if isinstance(value, dict):
        results: list[dict[str, Any]] = [{}]
        for key, val in value.items():
            if isinstance(val, list):
                if not val:
                    for r in results:
                        r[key] = []
                else:
                    expanded = []
                    for item in val:
                        expanded.extend(generic_flattening(item))
                    results = [
                        {**r, key: flattened} for flattened in expanded for r in results
                    ]
            elif isinstance(val, dict):
                nested = generic_flattening(val)
                results = [{**r, key: n} for n in nested for r in results]
            else:
                for r in results:
                    r[key] = val
        return results
    return [value]


def has_more_than_max_allowed_levels(value: Any, max_level: int, current_level: int = 1) -> bool:
    """True if nesting depth exceeds `max_level` (P_MAX_FLATTEN_LEVEL): a
    value inside k nested objects sits at level k + 1, list elements at the
    list's own level. Walked with an explicit stack."""
    stack = [(value, current_level)]
    while stack:
        v, level = stack.pop()
        if level > max_level:
            return True
        if isinstance(v, list):
            stack.extend((e, level) for e in v if isinstance(e, (list, dict)))
        elif isinstance(v, dict):
            for e in v.values():
                if isinstance(e, (list, dict)):
                    stack.append((e, level + 1))
                elif level + 1 > max_level:
                    return True
    return False


def convert_to_array(flattened: list[Any]) -> list[dict[str, Any]]:
    if any(not isinstance(item, dict) for item in flattened):
        raise JsonFlattenError("Expected object in array of objects")
    return flattened
