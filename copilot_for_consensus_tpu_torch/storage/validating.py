"""Schema-validating document store wrapper (parity with the reference's
``copilot_storage/validating_document_store.py:35``): every insert/upsert is
validated against the collection's schema from the registry; unknown
collections pass through unvalidated."""

from __future__ import annotations

from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.core.validation import (
    FileSchemaProvider,
    validate_json,
)
from copilot_for_consensus_tpu_torch.storage import registry
from copilot_for_consensus_tpu_torch.storage.base import DocumentStore


class ValidatingDocumentStore(DocumentStore):
    def __init__(self, inner: DocumentStore,
                 provider: FileSchemaProvider | None = None):
        self.inner = inner
        self.provider = provider

    def _validate(self, collection: str, doc: Mapping[str, Any]) -> None:
        name = registry.schema_name(collection)
        if name is not None:
            validate_json(doc, name, self.provider)

    def connect(self):
        self.inner.connect()

    def close(self):
        self.inner.close()

    def insert_document(self, collection, doc):
        self._validate(collection, doc)
        return self.inner.insert_document(collection, doc)

    def upsert_document(self, collection, doc):
        self._validate(collection, doc)
        return self.inner.upsert_document(collection, doc)

    def get_document(self, collection, doc_id):
        return self.inner.get_document(collection, doc_id)

    def query_documents(self, collection, flt=None, **kwargs):
        return self.inner.query_documents(collection, flt, **kwargs)

    def update_document(self, collection, doc_id, updates):
        # Merged docs are re-validated only when the collection is known and
        # the update could break required fields; cheap full check:
        current = self.inner.get_document(collection, doc_id)
        if current is not None:
            merged = {**current, **dict(updates)}
            self._validate(collection, merged)
        return self.inner.update_document(collection, doc_id, updates)

    def get_documents(self, collection, doc_ids):
        # Explicit: the base class inherits a concrete loop default, so
        # without this the wrapper would shadow the inner driver's
        # one-round-trip multi-get (the race-wrapper-shadow bug class).
        return self.inner.get_documents(collection, doc_ids)

    def insert_many(self, collection, docs, ignore_duplicates=True):
        docs = [dict(d) for d in docs]
        for doc in docs:
            self._validate(collection, doc)
        return self.inner.insert_many(collection, docs,
                                      ignore_duplicates)

    def update_documents(self, collection, doc_ids, updates):
        fields = dict(updates)
        current = self.inner.get_documents(collection, doc_ids)
        for doc in current.values():
            self._validate(collection, {**doc, **fields})
        return self.inner.update_documents(collection, doc_ids, fields)

    def delete_document(self, collection, doc_id):
        return self.inner.delete_document(collection, doc_id)

    def delete_documents(self, collection, flt=None):
        return self.inner.delete_documents(collection, flt)

    def count_documents(self, collection, flt=None):
        return self.inner.count_documents(collection, flt)

    def __getattr__(self, name):
        return getattr(self.inner, name)
