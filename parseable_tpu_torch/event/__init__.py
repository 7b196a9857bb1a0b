"""Event model: one parsed ingest unit and its way into staging.

Counterpart of `parseable_tpu/event/__init__.py` (reference:
src/event/mod.rs): `Event.process` commits first-seen schemas, then pushes
the batch into the stream's staging writer. Ingest metrics, spans and the
livetail fan-out are not ported; `livetail` is accepted and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import UTC, datetime
from typing import TYPE_CHECKING

import pyarrow as pa

from parseable_tpu_torch.event.format import LogSource, get_schema_key

if TYPE_CHECKING:
    from parseable_tpu_torch.streams import Stream


@dataclass
class Event:
    """One parsed ingest unit ready to enter staging."""

    stream_name: str
    rb: pa.RecordBatch
    origin_format: str = "json"
    origin_size: int = 0
    is_first_event: bool = False
    parsed_timestamp: datetime = field(default_factory=lambda: datetime.now(UTC))
    time_partition: str | None = None
    custom_partition_values: dict[str, str] = field(default_factory=dict)
    stream_type: str = "UserDefined"
    log_source: LogSource = LogSource.JSON
    # native columnar lane: the batch is payload-sized and backed by
    # contiguous native buffers — staging streams it straight into the
    # bucket's IPC file (no pending-regroup re-serialization)
    direct_staging: bool = False

    def get_schema_key(self) -> str:
        """Key of this batch's schema shape + partition suffix
        (reference: event/mod.rs:78-87,148)."""
        key = get_schema_key(list(self.rb.schema.names))
        ts = self.parsed_timestamp
        suffix = f"{ts.date()}{ts.hour:02d}{ts.minute:02d}"
        custom = "".join(f"{k}={v}" for k, v in sorted(self.custom_partition_values.items()))
        return f"{key}{suffix}{custom}" if (self.time_partition or custom) else key

    def process(self, stream: Stream, livetail=None, commit_schema=None) -> None:
        """Commit the schema when it is new or wider, then push into staging
        (reference: event/mod.rs:76-129)."""
        schema_key = get_schema_key(list(self.rb.schema.names))
        if (
            commit_schema is not None
            and not stream.metadata.static_schema_flag
            and (
                self.is_first_event
                or any(
                    name not in (stream.metadata.schema or {}) for name in self.rb.schema.names
                )
            )
        ):
            commit_schema(self.stream_name, self.rb.schema)
        ts = self.parsed_timestamp
        if ts.tzinfo is not None:
            ts = ts.astimezone(UTC).replace(tzinfo=None)
        stream.push(
            schema_key, self.rb, ts, self.custom_partition_values, direct=self.direct_staging
        )
        if stream.metadata.first_event_at is None:
            stream.metadata.first_event_at = self.parsed_timestamp.isoformat()
