"""Metastore: stream metadata, schemas and manifests as JSON on the store.

Counterpart of `parseable_tpu/metastore/__init__.py` (`ObjectStoreMetastore`),
limited to what the port reads and writes: stream JSON, the merged schema,
manifests and the node registry. Object keys and JSON match the JAX
package, so each package reads the other's lake and registry:

    <stream>/.stream/.stream.json               stream metadata (all/query)
    <stream>/.stream/ingestor.<id>.stream.json  an ingestor's own snapshot
    <stream>/.stream/.schema                    merged arrow schema
    <prefix>/manifest.json                      manifests
    .parseable/<type>.<node_id>.json            registered nodes
"""

from __future__ import annotations

import json
from typing import Any

import pyarrow as pa

from parseable_tpu_torch.catalog import Manifest
from parseable_tpu_torch.storage import (
    MANIFEST_FILE,
    PARSEABLE_ROOT_DIRECTORY,
    STREAM_ROOT_DIRECTORY,
    ObjectStoreFormat,
    schema_path,
    stream_json_path,
)
from parseable_tpu_torch.storage.object_storage import NoSuchKey, ObjectStorage


class MetastoreError(Exception):
    pass


def _schema_to_json(schema: pa.Schema) -> dict:
    return {
        "fields": [
            {"name": f.name, "data_type": str(f.type), "nullable": f.nullable} for f in schema
        ]
    }


_TYPES: dict[str, pa.DataType] = {
    "null": pa.null(),
    "bool": pa.bool_(),
    "int8": pa.int8(),
    "int16": pa.int16(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "uint8": pa.uint8(),
    "uint16": pa.uint16(),
    "uint32": pa.uint32(),
    "uint64": pa.uint64(),
    "float": pa.float32(),
    "double": pa.float64(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "string": pa.string(),
    "large_string": pa.large_string(),
    "binary": pa.binary(),
    "timestamp[ms]": pa.timestamp("ms"),
    "timestamp[us]": pa.timestamp("us"),
    "timestamp[ns]": pa.timestamp("ns"),
    "date32[day]": pa.date32(),
}


def _parse_type(s: str) -> pa.DataType:
    if s in _TYPES:
        return _TYPES[s]
    if s.startswith("list<") and s.endswith(">"):
        inner = s[5:-1]
        if ": " in inner:
            inner = inner.split(": ", 1)[1]
        return pa.list_(_parse_type(inner))
    return pa.string()


def _schema_from_json(obj: dict) -> pa.Schema:
    return pa.schema(
        [
            pa.field(f["name"], _parse_type(f["data_type"]), f.get("nullable", True))
            for f in obj.get("fields", [])
        ]
    )


class ObjectStoreMetastore:
    """Metadata CRUD over an ObjectStorage."""

    def __init__(self, storage: ObjectStorage):
        self.storage = storage

    def _get_json(self, key: str) -> dict | None:
        try:
            return json.loads(self.storage.get_object(key))
        except NoSuchKey:
            return None
        except json.JSONDecodeError as e:
            raise MetastoreError(f"corrupt metadata object {key}: {e}") from e

    def _put_json(self, key: str, doc: Any) -> None:
        self.storage.put_object(key, json.dumps(doc, default=str).encode())

    # -- streams ------------------------------------------------------------
    def get_stream_json(self, stream: str, node_id: str | None = None) -> ObjectStoreFormat:
        obj = self._get_json(stream_json_path(stream, node_id))
        if obj is None:
            raise MetastoreError(f"stream {stream} not found")
        return ObjectStoreFormat.from_json(obj)

    def get_all_stream_jsons(self, stream: str) -> list[ObjectStoreFormat]:
        """All nodes' stream jsons — a query merges their snapshots."""
        out = []
        for meta in self.storage.list_prefix(f"{stream}/{STREAM_ROOT_DIRECTORY}"):
            if meta.key.endswith("stream.json"):
                obj = self._get_json(meta.key)
                if obj is not None:
                    out.append(ObjectStoreFormat.from_json(obj))
        return out

    def put_stream_json(self, stream: str, fmt: ObjectStoreFormat, node_id: str | None = None) -> None:
        self._put_json(stream_json_path(stream, node_id), fmt.to_json())

    def list_streams(self) -> list[str]:
        out = []
        for d in self.storage.list_dirs(""):
            if d.startswith("."):
                continue
            if self.storage.list_dirs(d) or any(True for _ in self.storage.list_prefix(d)):
                out.append(d)
        return sorted(out)

    def delete_stream(self, stream: str) -> None:
        self.storage.delete_prefix(stream)

    # -- schema -------------------------------------------------------------
    def get_schema(self, stream: str) -> pa.Schema | None:
        obj = self._get_json(schema_path(stream))
        return _schema_from_json(obj) if obj is not None else None

    def put_schema(self, stream: str, schema: pa.Schema) -> None:
        self._put_json(schema_path(stream), _schema_to_json(schema))

    # -- manifests ----------------------------------------------------------
    def get_manifest(self, prefix: str) -> Manifest | None:
        obj = self._get_json(f"{prefix}/{MANIFEST_FILE}")
        return Manifest.from_json(obj) if obj is not None else None

    def put_manifest(self, prefix: str, manifest: Manifest) -> None:
        self._put_json(f"{prefix}/{MANIFEST_FILE}", manifest.to_json())

    # -- nodes --------------------------------------------------------------
    def list_nodes(self, node_type: str | None = None) -> list[dict]:
        """Registered nodes, of one type ("ingestor", "querier", "all") or
        of every type."""
        out = []
        for meta in self.storage.list_prefix(PARSEABLE_ROOT_DIRECTORY):
            if meta.key.endswith(".json"):
                obj = self._get_json(meta.key)
                if obj is not None and (node_type is None or obj.get("node_type") == node_type):
                    out.append(obj)
        return out

    def put_node(self, node: dict) -> None:
        node_type = node.get("node_type", "ingestor")
        self._put_json(f"{PARSEABLE_ROOT_DIRECTORY}/{node_type}.{node['node_id']}.json", node)

    def delete_node(self, node_id: str) -> None:
        for meta in list(self.storage.list_prefix(PARSEABLE_ROOT_DIRECTORY)):
            if node_id in meta.key:
                self.storage.delete_object(meta.key)
