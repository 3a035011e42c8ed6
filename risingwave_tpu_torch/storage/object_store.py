"""Object store — the durability boundary.

A copy of ``risingwave_tpu/storage/object_store.py`` with its imports rewritten
(host only: the port imports nothing of the reference).

Reference: src/object_store/ (ObjectStore trait; S3 object/s3.rs,
in-mem object/mem.rs, local-fs opendal engine). The streaming state
machine only needs put/read/list/delete of immutable blobs; everything
above (SSTs, manifests) is layered on that, so swapping local-FS for a
cloud store later changes nothing else.

Writes are atomic: LocalFsObjectStore stages to a temp file and
renames, so a crash mid-upload never leaves a half-written SST visible
(the reference gets this from S3 put semantics).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List


class ObjectStore:
    def put(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, off: int, length: int) -> bytes:
        """Partial object read (reference: ObjectStore::read with a
        block range, object/s3.rs ranged GET) — what block-granular
        SST reads ride on. Default: slice a full read (stores with a
        native ranged read override)."""
        return self.read(path)[off : off + length]

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def resilient(self, policy=None, breaker=None) -> "ObjectStore":
        """Wrap this store in the retrying, breaker-gated boundary
        (resilience.RetryingObjectStore) — the production posture for
        any store that can transiently fail. Idempotent: wrapping a
        wrapper returns it unchanged."""
        from risingwave_tpu_torch.resilience import RetryingObjectStore

        if isinstance(self, RetryingObjectStore):
            return self
        return RetryingObjectStore(self, policy, breaker)


class MemObjectStore(ObjectStore):
    """In-memory store (reference: object/mem.rs) — tests & sim."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.bytes_read = 0  # test observability: IO actually paid

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._blobs[path] = bytes(data)

    def read(self, path: str) -> bytes:
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(path)
            b = self._blobs[path]
            self.bytes_read += len(b)
            return b

    def read_range(self, path: str, off: int, length: int) -> bytes:
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(path)
            b = self._blobs[path][off : off + length]
            self.bytes_read += len(b)
            return b

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._blobs

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(p for p in self._blobs if p.startswith(prefix))

    def delete(self, path: str) -> None:
        with self._lock:
            self._blobs.pop(path, None)


class LocalFsObjectStore(ObjectStore):
    """Local filesystem store with atomic rename puts."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path))
        if not p.startswith(os.path.normpath(self.root)):
            raise ValueError(f"path escapes store root: {path}")
        return p

    def put(self, path: str, data: bytes) -> None:
        dst = self._abs(path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dst), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dst)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def read_range(self, path: str, off: int, length: int) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(off)
            return f.read(length)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list(self, prefix: str) -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix) and not rel.endswith(".tmp"):
                    out.append(rel)
        return sorted(out)

    def delete(self, path: str) -> None:
        try:
            os.unlink(self._abs(path))
        except FileNotFoundError:
            pass
