"""JSON event format -> Event (reference: src/event/format/json.rs).

Counterpart of `parseable_tpu/event/json_format.py`. `JsonEvent.into_event`
runs the to_data pipeline: conflict renames -> schema inference/merge ->
columnar decode -> p_timestamp & custom columns -> an `Event` ready for
staging. Cleanly typed batches take the vectorized `prepare_and_decode_fast`;
the rest the per-value `prepare_event` + `decode`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import UTC, datetime
from typing import Any

from parseable_tpu_torch.event import Event
from parseable_tpu_torch.event.format import (
    LogSource,
    decode,
    prepare_and_decode_fast,
    prepare_event,
)
from parseable_tpu_torch.streams import LogStreamMetadata
from parseable_tpu_torch.utils.arrowutil import add_parseable_fields
from parseable_tpu_torch.utils.timeutil import parse_rfc3339


class EventError(ValueError):
    pass


@dataclass
class JsonEvent:
    """A batch of flattened JSON records headed for one stream."""

    records: list[dict[str, Any]]
    stream_name: str
    origin_size: int = 0
    log_source: LogSource = LogSource.JSON
    custom_fields: dict[str, str] = field(default_factory=dict)
    p_timestamp: datetime = field(default_factory=lambda: datetime.now(UTC))

    def extract_custom_partition_values(self, custom_partition: str) -> dict[str, str]:
        """Values of custom partition fields from the first record
        (reference: json.rs:261)."""
        values: dict[str, str] = {}
        if not self.records:
            return values
        rec = self.records[0]
        for raw in custom_partition.split(","):
            name = raw.strip()
            v = rec.get(name)
            if v is not None:
                values[name] = str(v).strip('"')
        return values

    def into_event(self, metadata: LogStreamMetadata, stream_type: str = "UserDefined") -> Event:
        if metadata.static_schema_flag and metadata.schema:
            # static-schema streams reject undeclared fields outright
            declared = set(metadata.schema)
            extra = sorted({k for r in self.records for k in r} - declared)
            if extra:
                raise EventError(
                    f"fields {extra} are not part of the static schema for "
                    f"stream {self.stream_name!r}"
                )
        fast = prepare_and_decode_fast(
            self.records,
            metadata.schema or None,
            metadata.schema_version,
            metadata.time_partition,
            metadata.infer_timestamp,
        )
        if fast is not None:
            batch, _schema = fast
        else:
            prepared = prepare_event(
                self.records,
                metadata.schema or None,
                metadata.schema_version,
                metadata.time_partition,
                metadata.infer_timestamp,
            )
            batch = decode(prepared.records, prepared.schema)
        batch = add_parseable_fields(batch, self.p_timestamp, self.custom_fields)

        parsed_timestamp = self.p_timestamp
        if metadata.time_partition:
            v = self.records[0].get(metadata.time_partition) if self.records else None
            if isinstance(v, str):
                try:
                    parsed_timestamp = parse_rfc3339(v)
                except ValueError as e:
                    raise EventError(f"invalid time partition value: {v!r}") from e

        custom_values = (
            self.extract_custom_partition_values(metadata.custom_partition)
            if metadata.custom_partition
            else {}
        )

        origin_size = self.origin_size or len(json.dumps(self.records, default=str).encode())
        return Event(
            stream_name=self.stream_name,
            rb=batch,
            origin_format=self.log_source.value if self.log_source != LogSource.CUSTOM else "json",
            origin_size=origin_size,
            is_first_event=not metadata.schema,
            parsed_timestamp=parsed_timestamp,
            time_partition=metadata.time_partition,
            custom_partition_values=custom_values,
            stream_type=stream_type,
            log_source=self.log_source,
        )
