"""ObjectStorage interface + LocalFS implementation.

Counterpart of `parseable_tpu/storage/object_storage.py` (`ObjectStorage`
and `LocalFS`). The remote backends (S3, GCS, Azure) and the upload pool
are later slices; LocalFS is the `local-store` backend.
"""

from __future__ import annotations

import os
import shutil
import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator


class ObjectStorageError(Exception):
    pass


class NoSuchKey(ObjectStorageError):
    pass


@dataclass
class ObjectMeta:
    key: str
    size: int
    last_modified: float


class ObjectStorage(ABC):
    """Synchronous object-store primitives."""

    name: str = "abstract"

    @abstractmethod
    def get_object(self, key: str) -> bytes: ...

    @abstractmethod
    def put_object(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def list_prefix(self, prefix: str, recursive: bool = True) -> Iterator[ObjectMeta]: ...

    @abstractmethod
    def list_dirs(self, prefix: str) -> list[str]:
        """Immediate child 'directories' under a prefix."""

    @abstractmethod
    def upload_file(self, key: str, path: Path) -> None:
        """Upload a local file."""

    @abstractmethod
    def delete_object(self, key: str) -> None: ...

    def delete_prefix(self, prefix: str) -> None:
        """List-then-delete every object under `prefix`."""
        for meta in list(self.list_prefix(prefix)):
            self.delete_object(meta.key)

    def absolute_url(self, key: str) -> str:
        return key


class LocalFS(ObjectStorage):
    """Filesystem-backed object store (the `local-store` backend)."""

    name = "drive"

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _abs(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise ObjectStorageError(f"key escapes root: {key}")
        return p

    def _tmp(self, p: Path) -> Path:
        # writer-unique tmp name: several processes may share one store
        return p.with_name(f"{p.name}.{os.getpid()}.{threading.get_ident()}.tmp")

    def get_object(self, key: str) -> bytes:
        p = self._abs(key)
        if not p.is_file():
            raise NoSuchKey(key)
        return p.read_bytes()

    def put_object(self, key: str, data: bytes) -> None:
        p = self._abs(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._tmp(p)
        tmp.write_bytes(data)
        os.replace(tmp, p)

    def list_prefix(self, prefix: str, recursive: bool = True) -> Iterator[ObjectMeta]:
        base = self._abs(prefix) if prefix else self.root
        if not base.exists():
            return
        if base.is_file():
            st = base.stat()
            yield ObjectMeta(prefix, st.st_size, st.st_mtime)
            return
        pattern = "**/*" if recursive else "*"
        for p in sorted(base.glob(pattern)):
            if p.is_file() and not p.name.endswith(".tmp"):
                st = p.stat()
                yield ObjectMeta(str(p.relative_to(self.root)), st.st_size, st.st_mtime)

    def list_dirs(self, prefix: str) -> list[str]:
        base = self._abs(prefix) if prefix else self.root
        if not base.is_dir():
            return []
        return sorted(d.name for d in base.iterdir() if d.is_dir())

    def upload_file(self, key: str, path: Path) -> None:
        dest = self._abs(key)
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._tmp(dest)
        shutil.copyfile(path, tmp)
        os.replace(tmp, dest)

    def delete_object(self, key: str) -> None:
        self._abs(key).unlink(missing_ok=True)
