"""Stream registry and the staged-Parquet side of a stream.

Counterpart of `parseable_tpu/streams.py`, trimmed to what the query slice
needs: stream metadata, the staging directory's Parquet files, upload
claims and the staged-name -> object-key mapping. The Arrow-IPC writers and
`convert_disk_files_to_parquet` belong to the ingest slice;
`Stream.write_parquet` stages a finished table with the same name, sort
order and writer settings that conversion uses.

Staged Parquet is named
`date=D.hour=HH.minute=MM.{host}.{uid}.data.parquet` and uploads to
`<stream>/date=D/hour=HH/minute=MM/{host}.{uid}.data.parquet`.
"""

from __future__ import annotations

import os
import re
import socket
import threading
import uuid
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq

from parseable_tpu_torch import DEFAULT_TIMESTAMP_KEY, OBJECT_STORE_DATA_GRANULARITY
from parseable_tpu_torch.config import Options
from parseable_tpu_torch.utils.timeutil import minute_slot

_HOSTNAME = re.sub(r"[^A-Za-z0-9_-]", "", socket.gethostname()) or "node"


class StagingError(Exception):
    pass


@dataclass
class LogStreamMetadata:
    """In-memory per-stream metadata (the fields the query slice reads)."""

    schema: dict[str, pa.Field] = field(default_factory=dict)
    created_at: str = ""
    first_event_at: str | None = None


class Stream:
    """One log stream's staging directory and metadata."""

    def __init__(self, name: str, options: Options, metadata: LogStreamMetadata | None = None):
        self.name = name
        self.options = options
        self.metadata = metadata or LogStreamMetadata()
        self.data_path = options.staging_dir() / name
        self.lock = threading.RLock()
        # parquet claimed by an in-flight upload: two sync cycles must never
        # upload the same file twice
        self._claimed_parquet: set[Path] = set()  # guarded-by: self.lock

    def parquet_files(self) -> list[Path]:
        if not self.data_path.is_dir():
            return []
        return sorted(
            p
            for p in self.data_path.iterdir()
            if p.suffix == ".parquet" and not p.name.endswith(".part.parquet")
        )

    def claim_parquet(self, files: list[Path]) -> list[Path]:
        """Claim staged parquet for one upload cycle; already-claimed files
        are skipped."""
        with self.lock:
            out = [f for f in files if f not in self._claimed_parquet]
            self._claimed_parquet.update(out)
            return out

    def unclaim_parquet(self, f: Path) -> None:
        with self.lock:
            self._claimed_parquet.discard(f)

    def write_parquet(self, table: pa.Table, parsed_timestamp: datetime) -> Path:
        """Stage `table` as the parquet of the minute bucket holding
        `parsed_timestamp`: sorted newest-first by p_timestamp, with the
        configured row-group size and compression and per-column stats,
        written under a `.part.parquet` name and renamed when complete."""
        slot = minute_slot(parsed_timestamp.minute, OBJECT_STORE_DATA_GRANULARITY)
        group_key = (
            f"date={parsed_timestamp.date()}.hour={parsed_timestamp.hour:02d}"
            f".minute={slot}.{_HOSTNAME}"
        )
        if DEFAULT_TIMESTAMP_KEY in table.column_names:
            table = table.sort_by([(DEFAULT_TIMESTAMP_KEY, "descending")])
        self.data_path.mkdir(parents=True, exist_ok=True)
        final = self.data_path / f"{group_key}.{uuid.uuid4().hex[:16]}.data.parquet"
        part = final.with_name(final.name + ".part.parquet")
        pq.write_table(
            table,
            part,
            row_group_size=self.options.row_group_size,
            compression=self.options.parquet_compression.to_parquet(),
            write_statistics=True,
        )
        if part.stat().st_size == 0:
            part.unlink()
            raise StagingError(f"wrote empty parquet for {group_key}")
        os.replace(part, final)
        return final

    def stream_relative_path(self, parquet_path: Path) -> str:
        """Object-store key for a staged parquet file.

        `date=D.hour=HH.minute=MM.{custom...}.{host}.data.parquet` ->
        `<stream>/date=D/hour=HH/minute=MM/{custom.../}{host}.data.parquet`
        """
        parts = parquet_path.name.split(".data.")[0].split(".")
        path_parts: list[str] = []
        tail: list[str] = []
        for p in parts:
            if p.startswith(("date=", "hour=", "minute=")) or ("=" in p and not tail):
                path_parts.append(p)
            else:
                tail.append(p)
        filename = ".".join(tail + ["data", "parquet"])
        return "/".join([self.name, *path_parts, filename])


class Streams:
    """Registry of streams by name."""

    def __init__(self, options: Options):
        self.options = options
        self._streams: dict[str, Stream] = {}  # guarded-by: self._lock
        self._lock = threading.RLock()

    def get(self, name: str) -> Stream | None:
        with self._lock:
            return self._streams.get(name)

    def get_or_create(self, name: str, metadata: LogStreamMetadata | None = None) -> Stream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = Stream(name, self.options, metadata)
                self._streams[name] = s
            elif metadata is not None:
                s.metadata = metadata
            return s

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._streams

    def list_names(self) -> list[str]:
        with self._lock:
            return sorted(self._streams)
