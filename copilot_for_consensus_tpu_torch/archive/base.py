"""ArchiveStore ABC + drivers (reference ``archive_store.py`` with
LocalVolume / AzureBlob / MongoDB drivers — here: local volume, memory,
and a document-store-backed driver so a single backend can hold blobs)."""

from __future__ import annotations

import abc
import base64
import pathlib
from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver


class ArchiveStoreError(Exception):
    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        #: HTTP status for remote backends — callers branch on THIS,
        #: not on message substrings.
        self.status = status


def validate_archive_id(archive_id: str) -> str:
    """Reject rather than sanitize: a silently-renamed id would break
    content addressing (and ../ traversal must never reach storage).
    The ONE definition every driver shares."""
    if not archive_id or not all(
            (c.isascii() and c.isalnum()) or c in "-_"
            for c in archive_id):
        raise ArchiveStoreError(f"invalid archive id {archive_id!r}")
    return archive_id


class ArchiveStore(abc.ABC):
    @abc.abstractmethod
    def save(self, archive_id: str, content: bytes,
             metadata: dict[str, Any] | None = None) -> str:
        """Store the blob; returns a storage URI."""

    @abc.abstractmethod
    def load(self, archive_id: str) -> bytes: ...

    @abc.abstractmethod
    def exists(self, archive_id: str) -> bool: ...

    @abc.abstractmethod
    def delete(self, archive_id: str) -> bool: ...


class InMemoryArchiveStore(ArchiveStore):
    def __init__(self):
        self._blobs: dict[str, bytes] = {}

    def save(self, archive_id, content, metadata=None):
        self._blobs[archive_id] = bytes(content)
        return f"memory://{archive_id}"

    def load(self, archive_id):
        if archive_id not in self._blobs:
            raise ArchiveStoreError(f"archive not found: {archive_id}")
        return self._blobs[archive_id]

    def exists(self, archive_id):
        return archive_id in self._blobs

    def delete(self, archive_id):
        return self._blobs.pop(archive_id, None) is not None


class LocalVolumeArchiveStore(ArchiveStore):
    def __init__(self, root: str = "/var/lib/copilot/archives"):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, archive_id: str) -> pathlib.Path:
        return self.root / f"{validate_archive_id(archive_id)}.mbox"

    def save(self, archive_id, content, metadata=None):
        p = self._path(archive_id)
        p.write_bytes(content)
        return p.as_uri()

    def load(self, archive_id):
        p = self._path(archive_id)
        if not p.exists():
            raise ArchiveStoreError(f"archive not found: {archive_id}")
        return p.read_bytes()

    def exists(self, archive_id):
        return self._path(archive_id).exists()

    def delete(self, archive_id):
        p = self._path(archive_id)
        if p.exists():
            p.unlink()
            return True
        return False


class DocumentArchiveStore(ArchiveStore):
    """Blobs in the document store (base64 in a ``raw_archives``
    collection) — one durable backend for everything, the role the
    reference's MongoDBArchiveStore plays."""

    COLLECTION = "raw_archives"

    def __init__(self, document_store):
        self.store = document_store

    def save(self, archive_id, content, metadata=None):
        self.store.upsert_document(self.COLLECTION, {
            "archive_id": archive_id,
            "content_b64": base64.b64encode(content).decode(),
            **(metadata or {}),
        })
        return f"doc://{self.COLLECTION}/{archive_id}"

    def load(self, archive_id):
        doc = self.store.get_document(self.COLLECTION, archive_id)
        if doc is None:
            raise ArchiveStoreError(f"archive not found: {archive_id}")
        return base64.b64decode(doc["content_b64"])

    def exists(self, archive_id):
        return self.store.get_document(self.COLLECTION, archive_id) is not None

    def delete(self, archive_id):
        return self.store.delete_document(self.COLLECTION, archive_id)


def create_archive_store(config: Any = None, **kwargs: Any) -> ArchiveStore:
    driver = "memory"
    if config is not None:
        driver = (config.get("driver", "memory") if isinstance(config, dict)
                  else getattr(config, "driver", "memory"))
    if driver == "memory":
        return InMemoryArchiveStore()
    if driver == "local":
        root = (config.get("root") if isinstance(config, dict)
                else getattr(config, "root", None)) or kwargs.get("root")
        return LocalVolumeArchiveStore(root or "/var/lib/copilot/archives")
    if driver == "document":
        store = kwargs.get("document_store")
        if store is None:
            raise ValueError("document driver needs document_store=")
        return DocumentArchiveStore(store)
    if driver == "azure_blob":
        from copilot_for_consensus_tpu_torch.archive.azure_blob import (
            AzureBlobArchiveStore,
        )

        get = (config.get if isinstance(config, dict)
               else lambda k, d=None: getattr(config, k, d))
        return AzureBlobArchiveStore(
            account=get("account", ""),
            container=get("container", "archives"),
            account_key=get("account_key", "") or "",
            sas_token=get("sas_token", "") or "",
            endpoint=get("endpoint", "") or "")
    raise ValueError(f"unknown archive_store driver {driver!r}")


for _name in ("memory", "local", "document", "azure_blob"):
    register_driver("archive_store", _name, create_archive_store)
