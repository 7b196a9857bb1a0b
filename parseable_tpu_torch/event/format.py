"""Event format: JSON -> Arrow schema inference, widening, conflict renaming.

Counterpart of `parseable_tpu/event/format.py`, trimmed to the Python lane
(reference: src/event/format/mod.rs:148-620, json.rs:42-556):

- infer an Arrow schema from flattened JSON records;
- SchemaVersion.V1: every number infers as float64; string fields whose name
  contains a time-ish part and whose value parses as a datetime infer as
  timestamp(ms) (gated on `infer_timestamp`);
- fields already present in the stream schema keep the stored type;
- values incompatible with the stored type cause a *per-record* rename of the
  offending field to `{name}_{type-suffix}` so ingest never fails on type
  drift (detect_schema_conflicts / rename_per_record_type_mismatches).

`prepare_and_decode_fast` types cleanly typed batches through Arrow's C++
builders and declines (None) where the per-value pipeline (`prepare_event`
+ `decode`) must decide; `fast_columns_from_table` is its column half,
shared with the native ingest lane's tables.
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field as dc_field
from datetime import UTC, datetime
from enum import Enum
from typing import Any

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from parseable_tpu_torch.utils.timeutil import parse_rfc3339

logger = logging.getLogger(__name__)

# Field-name fragments that suggest a timestamp value
# (reference: event/format/mod.rs:46 TIME_FIELD_NAME_PARTS)
TIME_FIELD_NAME_PARTS = (
    "time",
    "date",
    "timestamp",
    "created",
    "received",
    "ingested",
    "collected",
    "start",
    "end",
    "at",
    "_ts",
)


class SchemaVersion(str, Enum):
    V0 = "v0"
    V1 = "v1"


class LogSource(str, Enum):
    """Where an event came from (reference: event/format/mod.rs:73-99)."""

    JSON = "json"
    OTEL_LOGS = "otel-logs"
    OTEL_METRICS = "otel-metrics"
    OTEL_TRACES = "otel-traces"
    KINESIS = "kinesis"
    PMETA = "pmeta"
    CUSTOM = "custom"

    @classmethod
    def from_str(cls, s: str) -> "LogSource":
        try:
            return cls(s.lower())
        except ValueError:
            return cls.CUSTOM


def normalize_field_name(name: str) -> str:
    """Replace a leading '@' with '_' (reference: mod.rs:65)."""
    return "_" + name[1:] if name.startswith("@") else name


def datatype_suffix(t: pa.DataType) -> str:
    """Short type tag used when renaming conflicting fields."""
    if pa.types.is_null(t):
        return "null"
    if pa.types.is_boolean(t):
        return "bool"
    if pa.types.is_integer(t):
        return str(t)  # int64 / uint64 / ...
    if t == pa.float64():
        return "float64"
    if t == pa.float32():
        return "float32"
    if pa.types.is_timestamp(t):
        return "ts"
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return "str"
    if pa.types.is_list(t):
        return "list"
    return str(t)


def _is_timestampy(name: str) -> bool:
    lname = name.lower()
    return any(part in lname for part in TIME_FIELD_NAME_PARTS)


def _parses_as_datetime(s: str) -> bool:
    try:
        parse_rfc3339(s)
        return True
    except ValueError:
        return False


def infer_value_type(
    name: str,
    value: Any,
    schema_version: SchemaVersion = SchemaVersion.V1,
    infer_timestamp: bool = True,
) -> pa.DataType:
    """Arrow type for one JSON value under the given schema version."""
    if value is None:
        return pa.null()
    if isinstance(value, bool):
        return pa.bool_()
    if isinstance(value, int):
        return pa.float64() if schema_version == SchemaVersion.V1 else pa.int64()
    if isinstance(value, float):
        return pa.float64()
    if isinstance(value, str):
        if (
            schema_version == SchemaVersion.V1
            and infer_timestamp
            and _is_timestampy(normalize_field_name(name))
            and _parses_as_datetime(value)
        ):
            return pa.timestamp("ms")
        return pa.string()
    if isinstance(value, list):
        elem = pa.null()
        for v in value:
            t = infer_value_type(name, v, schema_version, infer_timestamp)
            elem = _merge_types(elem, t)
        return pa.list_(elem)
    if isinstance(value, dict):
        # objects should have been flattened; store residue as JSON text
        return pa.string()
    return pa.string()


_STRING = pa.string()
_TIMESTAMP_MS = pa.timestamp("ms")
_FLOAT64 = pa.float64()
# exact types whose inferred type and compatibility depend on the type alone
_SCALAR_TYPES = (bool, int, float, type(None), dict)


def _merge_types(a: pa.DataType, b: pa.DataType) -> pa.DataType:
    if a == b:
        return a
    if pa.types.is_null(a):
        return b
    if pa.types.is_null(b):
        return a
    if pa.types.is_integer(a) and pa.types.is_floating(b):
        return b
    if pa.types.is_floating(a) and pa.types.is_integer(b):
        return a
    if pa.types.is_timestamp(a) and pa.types.is_string(b):
        return a
    if pa.types.is_string(a) and pa.types.is_timestamp(b):
        return b
    return pa.string()


def infer_json_schema(
    records: list[dict[str, Any]],
    schema_version: SchemaVersion = SchemaVersion.V1,
    infer_timestamp: bool = True,
) -> pa.Schema:
    """Infer a sorted-by-name schema over all records.

    Same result as merging `infer_value_type` over every value, with that
    function's answers memoized on what they depend on: the exact Python
    type for scalars and objects, the string itself for strings under a
    time-ish name, nothing for other strings. Lists and other types call it
    per value."""
    types: dict[str, pa.DataType] = {}
    names: dict[str, str] = {}
    ts_names: dict[str, bool] = {}
    by_type: dict[type, pa.DataType] = {}
    parses: dict[str, bool] = {}
    for rec in records:
        for key, value in rec.items():
            name = names.get(key)
            if name is None:
                name = names[key] = normalize_field_name(key)
            vt = type(value)
            if vt is str:
                ts_name = ts_names.get(name)
                if ts_name is None:
                    ts_name = ts_names[name] = (
                        schema_version == SchemaVersion.V1
                        and infer_timestamp
                        and _is_timestampy(normalize_field_name(name))
                    )
                t = _STRING
                if ts_name:
                    ok = parses.get(value)
                    if ok is None:
                        ok = parses[value] = _parses_as_datetime(value)
                    if ok:
                        t = _TIMESTAMP_MS
            elif vt in _SCALAR_TYPES:
                t = by_type.get(vt)
                if t is None:
                    t = by_type[vt] = infer_value_type(name, value, schema_version, infer_timestamp)
            else:
                t = infer_value_type(name, value, schema_version, infer_timestamp)
            prev = types.get(name)
            if prev is None:
                types[name] = t
            elif prev is not t and prev != t:
                types[name] = _merge_types(prev, t)
    for name, t in types.items():
        if pa.types.is_null(t):
            types[name] = pa.string()
    fields = [pa.field(name, t, nullable=True) for name, t in sorted(types.items())]
    return pa.schema(fields)


def update_field_type_in_schema(
    inferred: pa.Schema,
    existing: dict[str, pa.Field] | None,
    time_partition: str | None = None,
) -> pa.Schema:
    """Apply stored-schema overrides to an inferred schema.

    - fields stored as timestamp stay timestamps even when a record's value
      inferred as string;
    - a new time-partition column inferred as string becomes timestamp(ms).
    """
    fields: list[pa.Field] = []
    existing = existing or {}
    for f in inferred:
        stored = existing.get(f.name)
        if stored is not None and pa.types.is_timestamp(stored.type):
            fields.append(pa.field(f.name, stored.type, nullable=True))
        elif (
            time_partition is not None
            and f.name == time_partition
            and f.name not in existing
            and pa.types.is_string(f.type)
        ):
            fields.append(pa.field(f.name, pa.timestamp("ms"), nullable=True))
        else:
            fields.append(pa.field(f.name, f.type, nullable=True))
    return pa.schema(fields)


def value_compatible_with_type(value: Any, t: pa.DataType) -> bool:
    """Can `value` be stored in a column of type `t` without corruption?

    (reference: event/format/mod.rs:442-487)
    """
    if value is None:
        return True
    if pa.types.is_boolean(t):
        return isinstance(value, bool)
    if pa.types.is_integer(t):
        return isinstance(value, int) and not isinstance(value, bool)
    if pa.types.is_floating(t):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if pa.types.is_timestamp(t):
        return isinstance(value, str) and _parses_as_datetime(value)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return isinstance(value, str)
    if pa.types.is_list(t):
        return isinstance(value, list)
    return True


def detect_schema_conflicts(
    records: list[dict[str, Any]],
    stored: dict[str, pa.Field],
    schema_version: SchemaVersion = SchemaVersion.V1,
) -> dict[str, str]:
    """Map of field name -> renamed field name for records whose value type
    conflicts with the stored column type. `value_compatible_with_type` is
    memoized per field on the exact value type, except for strings under a
    timestamp column, whose answer depends on the string."""
    renames: dict[str, str] = {}
    if not stored:
        return renames
    names: dict[str, str] = {}
    compatible: dict[tuple[str, type], bool] = {}
    for rec in records:
        for key, value in rec.items():
            if value is None:
                continue
            name = names.get(key)
            if name is None:
                name = names[key] = normalize_field_name(key)
            f = stored.get(name)
            if f is None:
                continue
            memo_key = (name, type(value))
            ok = compatible.get(memo_key)
            if ok is None:
                ok = value_compatible_with_type(value, f.type)
                if not (isinstance(value, str) and pa.types.is_timestamp(f.type)):
                    compatible[memo_key] = ok
            if not ok:
                vt = infer_value_type(name, value, schema_version)
                renames[name] = f"{name}_{datatype_suffix(vt)}"
    return renames


def rename_per_record_type_mismatches(
    records: list[dict[str, Any]],
    stored: dict[str, pa.Field],
    renames: dict[str, str],
) -> list[dict[str, Any]]:
    """Rename only the offending fields in only the offending records."""
    if not renames:
        return records
    out = []
    for rec in records:
        new_rec = {}
        for key, value in rec.items():
            name = normalize_field_name(key)
            target = renames.get(name)
            if (
                target is not None
                and name in stored
                and value is not None
                and not value_compatible_with_type(value, stored[name].type)
            ):
                new_rec[target] = value
            else:
                new_rec[name] = value
        out.append(new_rec)
    return out


_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh_round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def _xxh_merge(h: int, v: int) -> int:
    return ((h ^ _xxh_round(0, v)) * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of `data` (the public XXH64 algorithm, pure Python)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        while i + 32 <= n:
            a, b, c, d = struct.unpack_from("<4Q", data, i)
            v1, v2, v3, v4 = (
                _xxh_round(v1, a), _xxh_round(v2, b), _xxh_round(v3, c), _xxh_round(v4, d)
            )
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _xxh_merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, i)
        h = (_rotl(h ^ _xxh_round(0, k), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl(h ^ ((k * _P1) & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ ((data[i] * _P5) & _M64), 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def get_schema_key(fields: list[str]) -> str:
    """Stable 64-bit hex key over sorted field names: xxHash64, as the JAX
    package computes it with its native library (its pure-Python fallbacks
    differ). The key only groups staging files by schema shape."""
    payload = b"\x00".join(name.encode() for name in sorted(fields))
    return f"{xxh64(payload):016x}"


@dataclass
class EventSchema:
    """An inferred + reconciled schema plus the records ready to encode."""

    schema: pa.Schema
    records: list[dict[str, Any]]
    is_first: bool = False
    renames: dict[str, str] = dc_field(default_factory=dict)


def prepare_event(
    records: list[dict[str, Any]],
    stored_schema: dict[str, pa.Field] | None,
    schema_version: SchemaVersion = SchemaVersion.V1,
    time_partition: str | None = None,
    infer_timestamp: bool = True,
) -> EventSchema:
    """Full `to_data` pipeline: conflict renames -> inference -> overrides."""
    stored = stored_schema or {}
    # normalize '@'-prefixed keys in the RECORDS too — the schema infers
    # normalized names, and decode() looks values up by those names (a
    # schema-only normalization silently dropped the values). When '@x'
    # and '_x' coexist in one record, the explicit '_x' value wins
    # (deterministic; logged so the drop is diagnosable).
    if any(k.startswith("@") for rec in records for k in rec):
        normalized_records = []
        for rec in records:
            new_rec: dict[str, Any] = {}
            for k, v in rec.items():
                nk = normalize_field_name(k)
                if nk in new_rec or (k.startswith("@") and nk in rec):
                    if k.startswith("@"):
                        logger.debug("field %r collides with %r; keeping the latter", k, nk)
                        continue
                new_rec[nk] = v
            normalized_records.append(new_rec)
        records = normalized_records
    renames = detect_schema_conflicts(records, stored, schema_version)
    records = rename_per_record_type_mismatches(records, stored, renames)
    inferred = infer_json_schema(records, schema_version, infer_timestamp)
    merged_fields: list[pa.Field] = []
    for f in inferred:
        stored_f = stored.get(f.name)
        if stored_f is not None:
            merged_fields.append(pa.field(f.name, stored_f.type, nullable=True))
        else:
            merged_fields.append(f)
    schema = update_field_type_in_schema(pa.schema(merged_fields), stored, time_partition)
    is_first = not stored
    return EventSchema(schema=schema, records=records, is_first=is_first, renames=renames)


def _coerce(value: Any, t: pa.DataType) -> Any:
    if value is None:
        return None
    if pa.types.is_timestamp(t):
        if isinstance(value, str):
            try:
                return parse_rfc3339(value).replace(tzinfo=None)
            except ValueError:
                return None
        if isinstance(value, (int, float)):
            return datetime.fromtimestamp(value / 1000.0, UTC).replace(tzinfo=None)
        if isinstance(value, datetime):
            return value
        return None
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        if isinstance(value, str):
            return value
        import json as _json

        return _json.dumps(value, separators=(",", ":"), default=str)
    if pa.types.is_floating(t):
        return float(value) if isinstance(value, (int, float)) and not isinstance(value, bool) else None
    if pa.types.is_integer(t):
        return int(value) if isinstance(value, (int, float)) and not isinstance(value, bool) else None
    if pa.types.is_boolean(t):
        return value if isinstance(value, bool) else None
    if pa.types.is_list(t):
        if not isinstance(value, list):
            return None
        return [_coerce(v, t.value_type) for v in value]
    return value


def prepare_and_decode_fast(
    records: list[dict[str, Any]],
    stored_schema: dict[str, pa.Field] | None,
    schema_version: SchemaVersion = SchemaVersion.V1,
    time_partition: str | None = None,
    infer_timestamp: bool = True,
) -> tuple[pa.RecordBatch, pa.Schema] | None:
    """Vectorized prepare+decode through Arrow's C++ builders — the Python
    lane's fast path (the reference leans on arrow-json's Decoder the same
    way, ingest.rs:60, json.rs:189).

    Returns None whenever the batch needs the exact slow-path semantics:
    per-record type-conflict renames, mixed-type columns, nested values,
    time partitions, or time-ish strings that only partially parse. The
    caller then runs prepare_event + decode, so behavior is identical —
    this path only accelerates batches whose columns are cleanly typed.
    """
    if schema_version != SchemaVersion.V1 or time_partition is not None or not records:
        return None
    try:
        tbl = pa.Table.from_pylist(records)
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
        return None  # mixed-type column etc. -> slow path
    except OverflowError:
        # ints beyond int64 overflow Arrow's inference; the slow path
        # stages them as float64
        return None
    # from_pylist infers columns from the first record; sparse batches
    # (later records adding keys) need the per-record slow path
    union_keys = set()
    for rec in records:
        union_keys.update(rec)
    if len(union_keys) != len(tbl.column_names):
        return None
    return fast_columns_from_table(tbl, stored_schema, infer_timestamp, records)


def fast_columns_from_table(
    tbl: pa.Table,
    stored_schema: dict[str, pa.Field] | None,
    infer_timestamp: bool = True,
    records: list[dict[str, Any]] | None = None,
) -> tuple[pa.RecordBatch, pa.Schema] | None:
    """Column-normalization half of the fast path, shared with the native
    ingest lane (server/ingest_utils.py): the table there comes from the
    columnar tier's buffers or from pyarrow's JSON reader over natively
    flattened NDJSON, so `records` is None — record-dependent guards are
    replaced by facts of those builders (a bool mixed into a numeric column
    makes both decline rather than coerce)."""
    stored = stored_schema or {}
    normalized = [normalize_field_name(n) for n in tbl.column_names]
    if len(set(normalized)) != len(normalized):
        return None  # '@x' colliding with 'x' needs per-record handling

    out: dict[str, pa.Array] = {}
    for raw_name, name in zip(tbl.column_names, normalized):
        col = tbl.column(raw_name).combine_chunks()
        t = col.type
        stored_f = stored.get(name)
        if pa.types.is_struct(t) or pa.types.is_list(t) or pa.types.is_large_list(t):
            return None  # nested residue / list coercion: slow path
        # V1 base mapping
        if pa.types.is_null(t):
            target: pa.DataType = pa.string()
        elif pa.types.is_boolean(t):
            target = pa.bool_()
        elif pa.types.is_integer(t) or pa.types.is_floating(t):
            # pyarrow treats Python bool as numeric: a bool mixed into a
            # numeric column would silently become 1.0/0.0 here, while the
            # slow path types the column string — decline instead (read_json
            # sources can't mix: the reader raises on bool-in-number)
            if records is not None and any(
                isinstance(rec.get(raw_name), bool) for rec in records
            ):
                return None
            target = pa.float64()
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            target = pa.string()
        elif pa.types.is_timestamp(t):
            # read_json eagerly parses ISO-looking strings into timestamps
            # regardless of field name; the slow path only infers time for
            # time-ish names AND only when the stream infers timestamps —
            # decline the mismatch instead of committing (with inference
            # off, a pre-typed ts column would stage where the Python path
            # stages strings)
            if records is None and not (
                (infer_timestamp and _is_timestampy(name))
                or (stored.get(name) is not None and pa.types.is_timestamp(stored[name].type))
            ):
                return None
            target = pa.timestamp("ms")
        else:
            return None
        # timestamp inference for time-ish string columns: the slow path
        # types the column ts when ANY value parses and nulls the rest;
        # the fast path takes only the all-parse case and falls back on
        # partial parses
        wants_ts = (
            target == pa.string()
            and infer_timestamp
            and _is_timestampy(name)
            and not (stored_f is not None and pa.types.is_string(stored_f.type))
        )
        if stored_f is not None and pa.types.is_timestamp(stored_f.type):
            wants_ts = pa.types.is_string(t) or pa.types.is_timestamp(t)
            if not wants_ts:
                return None  # non-string under a ts column: slow path
        if (
            wants_ts
            and stored_f is None
            and pa.types.is_string(t)
            and not any(_parses_as_datetime(v) for v in pc.unique(col).drop_null().to_pylist())
        ):
            # a new column under a time-ish name none of whose values parse
            # the way the slow path checks them (once per distinct string,
            # stopping at the first that parses): the slow path infers
            # string, so it stays string. The JAX package tries the casts
            # below and declines, e.g. on every body with a `path` column
            # ("at" is a time-ish name part), for the same table.
            wants_ts = False
        if wants_ts and pa.types.is_string(t):
            # Arrow refuses LOSSY string->timestamp casts, so sub-ms
            # precision strings (OTel emits microseconds) must parse at a
            # finer unit first, then truncate to ms with safe=False —
            # exactly what the slow path's parse_rfc3339 -> ms flooring does
            parsed = None
            for unit in ("ms", "us", "ns"):
                try:
                    # tz-suffixed strings -> UTC -> naive, matching
                    # parse_rfc3339().replace(tzinfo=None)
                    parsed = pc.cast(col, pa.timestamp(unit, tz="UTC"))
                    parsed = pc.cast(parsed, pa.timestamp(unit))
                    break
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                    try:
                        # zone-less naive ISO strings cast directly
                        parsed = pc.cast(col, pa.timestamp(unit))
                        break
                    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                        parsed = None
            if parsed is not None:
                if parsed.type != pa.timestamp("ms"):
                    # FLOOR to ms (Arrow's unsafe cast truncates toward
                    # zero, which would round pre-1970 values up by 1 ms vs
                    # the slow path's parse_rfc3339 flooring)
                    unit_per_ms = {"us": 1_000, "ns": 1_000_000}[parsed.type.unit]
                    ints = pc.cast(parsed, pa.int64())
                    nulls = pc.is_null(ints).to_numpy(zero_copy_only=False)
                    filled = pc.fill_null(ints, 0).to_numpy(zero_copy_only=False)
                    floored = np.floor_divide(filled, unit_per_ms)
                    parsed = pc.cast(
                        pa.array(floored, type=pa.int64(), mask=nulls),
                        pa.timestamp("ms"),
                    )
                col = parsed
                target = pa.timestamp("ms")
            else:
                # Arrow couldn't parse every value (partial parses, mixed
                # zones, sub-ms precision, or plain non-time strings): the
                # slow path decides per value — never silently commit a
                # string column where it would infer timestamp
                return None
        # stored-schema overrides + column-level compatibility
        if stored_f is not None and not pa.types.is_timestamp(stored_f.type):
            st = stored_f.type
            if pa.types.is_string(st):
                if not (pa.types.is_string(target)):
                    return None  # e.g. numbers under a stored string column
            elif pa.types.is_floating(st):
                if not pa.types.is_floating(target):
                    return None
            elif pa.types.is_integer(st):
                # V1 widened everything to float64; an int-typed stored
                # column means V0 data — slow path handles it
                return None
            elif pa.types.is_boolean(st):
                if not pa.types.is_boolean(target):
                    return None
            else:
                return None
            target = st
        if col.type != target:
            try:
                col = pc.cast(col, target)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                return None
        out[name] = col
    names = sorted(out)
    schema = pa.schema([pa.field(n, out[n].type, nullable=True) for n in names])
    batch = pa.record_batch([out[n] for n in names], schema=schema)
    return batch, schema


def decode(records: list[dict[str, Any]], schema: pa.Schema) -> pa.RecordBatch:
    """Columnar-encode records against `schema` (arrow-json Decoder parity).
    Values `_coerce` returns unchanged (strings in a string column, floats
    in a float64 column, nulls) skip the call; timestamp strings are parsed
    once per distinct string."""
    cols = []
    for f in schema:
        t = f.type
        values = [rec.get(f.name) for rec in records]
        if t == _STRING:
            values = [v if type(v) is str or v is None else _coerce(v, t) for v in values]
        elif t == _FLOAT64:
            values = [v if type(v) is float or v is None else _coerce(v, t) for v in values]
        elif pa.types.is_timestamp(t):
            parsed: dict[str, Any] = {}
            out = []
            for v in values:
                if type(v) is str:
                    c = parsed.get(v, parsed)
                    if c is parsed:
                        c = parsed[v] = _coerce(v, t)
                    out.append(c)
                else:
                    out.append(_coerce(v, t))
            values = out
        else:
            values = [_coerce(v, t) for v in values]
        cols.append(pa.array(values, type=t))
    return pa.RecordBatch.from_arrays(cols, schema=schema)
