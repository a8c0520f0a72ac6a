"""In-memory document store (tests + single-process pipeline runs)."""

from __future__ import annotations

import copy
import threading
from typing import Any, Mapping, Sequence

from copilot_for_consensus_tpu_torch.storage import registry
from copilot_for_consensus_tpu_torch.storage.base import (
    DocumentStore,
    DuplicateKeyError,
    matches_filter,
    sort_documents,
)


class InMemoryDocumentStore(DocumentStore):
    def __init__(self, config: Any = None):
        self._collections: dict[str, dict[str, dict]] = {}
        self._lock = threading.RLock()

    def _coll(self, name: str) -> dict[str, dict]:
        return self._collections.setdefault(name, {})

    def _key(self, collection: str, doc: Mapping[str, Any]) -> str:
        pk = registry.primary_key(collection)
        doc_id = doc.get(pk)
        if not doc_id:
            raise DuplicateKeyError(
                f"document for {collection!r} missing primary key {pk!r}")
        return str(doc_id)

    def insert_document(self, collection, doc):
        with self._lock:
            coll = self._coll(collection)
            doc_id = self._key(collection, doc)
            if doc_id in coll:
                raise DuplicateKeyError(f"{collection}/{doc_id} exists")
            coll[doc_id] = copy.deepcopy(dict(doc))
            return doc_id

    def upsert_document(self, collection, doc):
        with self._lock:
            doc_id = self._key(collection, doc)
            self._coll(collection)[doc_id] = copy.deepcopy(dict(doc))
            return doc_id

    def get_document(self, collection, doc_id):
        with self._lock:
            doc = self._coll(collection).get(str(doc_id))
            return copy.deepcopy(doc) if doc is not None else None

    def query_documents(self, collection, flt=None, *, limit=None, skip=0,
                        sort: Sequence[tuple[str, int]] | None = None):
        with self._lock:
            docs = [copy.deepcopy(d) for d in self._coll(collection).values()
                    if matches_filter(d, flt)]
        sort_documents(docs, sort)
        if skip:
            docs = docs[skip:]
        if limit is not None:
            docs = docs[:limit]
        return docs

    def update_document(self, collection, doc_id, updates):
        with self._lock:
            coll = self._coll(collection)
            doc = coll.get(str(doc_id))
            if doc is None:
                return False
            doc.update(copy.deepcopy(dict(updates)))
            return True

    def get_documents(self, collection, doc_ids):
        # one lock acquisition for the whole wave (the batched hot
        # paths' multi-get), instead of one per id
        with self._lock:
            coll = self._coll(collection)
            out = {}
            for doc_id in doc_ids:
                key = str(doc_id)
                if key in out:
                    continue
                doc = coll.get(key)
                if doc is not None:
                    out[key] = copy.deepcopy(doc)
            return out

    def update_documents(self, collection, doc_ids, updates):
        with self._lock:
            coll = self._coll(collection)
            n = 0
            seen: set[str] = set()
            fields = copy.deepcopy(dict(updates))
            for doc_id in doc_ids:
                key = str(doc_id)
                if key in seen:
                    continue
                seen.add(key)
                doc = coll.get(key)
                if doc is not None:
                    doc.update(copy.deepcopy(fields))
                    n += 1
            return n

    def delete_document(self, collection, doc_id):
        with self._lock:
            return self._coll(collection).pop(str(doc_id), None) is not None

    def delete_documents(self, collection, flt=None):
        with self._lock:
            coll = self._coll(collection)
            to_delete = [k for k, d in coll.items() if matches_filter(d, flt)]
            for k in to_delete:
                del coll[k]
            return len(to_delete)

    def count_documents(self, collection, flt=None):
        with self._lock:
            if not flt:
                return len(self._coll(collection))
            return sum(1 for d in self._coll(collection).values()
                       if matches_filter(d, flt))
