"""DocumentStore ABC + the Mongo-style filter subset shared by drivers.

Filter language (enough for every query the pipeline makes):
equality, ``$ne``, ``$in``, ``$nin``, ``$exists``, ``$lt/$lte/$gt/$gte``,
``$regex``, ``$or`` (list of sub-filters), and dotted paths for nested
fields.
"""

from __future__ import annotations

import abc
import re
from typing import Any, Iterable, Mapping, Sequence

from copilot_for_consensus_tpu_torch.core.retry import RetryableError


class StorageError(Exception):
    pass


class DuplicateKeyError(StorageError):
    """Insert with an already-present primary key (idempotent stages catch
    this and treat it as success — reference behavior at
    ``chunking/app/service.py:343``)."""


class StorageContentionError(StorageError, RetryableError):
    """Transient lock/contention inside the store (sqlite ``database is
    locked`` under concurrent writers, Cosmos 429s, ...). Being a
    :class:`RetryableError` it rides the in-process retry + backoff and
    then the bus lease/redelivery path — infrastructure contention must
    never be classified as poison and quarantined (diagnosed from a
    ``pipeline_chaos`` storm where 35 locked writes dead-lettered good
    work; ``docs/RESILIENCE.md`` poison-vs-transient table)."""


def _resolve_path(doc: Mapping[str, Any], path: str):
    node: Any = doc
    for part in path.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return None, False
        node = node[part]
    return node, True


_OPS = {
    "$ne": lambda value, arg: value != arg,
    "$in": lambda value, arg: value in arg,
    "$nin": lambda value, arg: value not in arg,
    "$lt": lambda value, arg: value is not None and value < arg,
    "$lte": lambda value, arg: value is not None and value <= arg,
    "$gt": lambda value, arg: value is not None and value > arg,
    "$gte": lambda value, arg: value is not None and value >= arg,
    "$regex": lambda value, arg: isinstance(value, str) and re.search(arg, value) is not None,
}


def _match_condition(doc: Mapping[str, Any], path: str, cond: Any) -> bool:
    value, exists = _resolve_path(doc, path)
    if isinstance(cond, Mapping) and any(k.startswith("$") for k in cond):
        for op, arg in cond.items():
            if op == "$exists":
                if bool(arg) != exists:
                    return False
            elif op in _OPS:
                if not exists and op != "$ne":
                    return False
                if not _OPS[op](value, arg):
                    return False
            else:
                raise StorageError(f"unsupported filter operator {op!r}")
        return True
    return exists and value == cond


def matches_filter(doc: Mapping[str, Any], flt: Mapping[str, Any] | None) -> bool:
    if not flt:
        return True
    for key, cond in flt.items():
        if key == "$or":
            if not any(matches_filter(doc, sub) for sub in cond):
                return False
        elif key == "$and":
            if not all(matches_filter(doc, sub) for sub in cond):
                return False
        elif not _match_condition(doc, key, cond):
            return False
    return True


def sort_documents(docs: list[dict], sort: Sequence[tuple[str, int]] | None) -> list[dict]:
    if not sort:
        return docs
    for field_name, direction in reversed(list(sort)):
        docs.sort(
            key=lambda d: ((v := _resolve_path(d, field_name)[0]) is None, v),
            reverse=direction < 0,
        )
    return docs


class DocumentStore(abc.ABC):
    """CRUD + query over named collections of JSON documents."""

    def connect(self) -> None:
        pass

    def close(self) -> None:
        pass

    @abc.abstractmethod
    def insert_document(self, collection: str, doc: Mapping[str, Any]) -> str:
        """Insert; raises DuplicateKeyError if the primary key exists."""

    @abc.abstractmethod
    def upsert_document(self, collection: str, doc: Mapping[str, Any]) -> str: ...

    @abc.abstractmethod
    def get_document(self, collection: str, doc_id: str) -> dict[str, Any] | None: ...

    @abc.abstractmethod
    def query_documents(self, collection: str,
                        flt: Mapping[str, Any] | None = None, *,
                        limit: int | None = None, skip: int = 0,
                        sort: Sequence[tuple[str, int]] | None = None
                        ) -> list[dict[str, Any]]: ...

    @abc.abstractmethod
    def update_document(self, collection: str, doc_id: str,
                        updates: Mapping[str, Any]) -> bool:
        """Shallow-merge updates into the doc; False if absent."""

    @abc.abstractmethod
    def delete_document(self, collection: str, doc_id: str) -> bool: ...

    @abc.abstractmethod
    def delete_documents(self, collection: str,
                         flt: Mapping[str, Any] | None = None) -> int: ...

    @abc.abstractmethod
    def count_documents(self, collection: str,
                        flt: Mapping[str, Any] | None = None) -> int: ...

    def insert_or_ignore(self, collection: str, doc: Mapping[str, Any]) -> bool:
        """Idempotent insert: True if inserted, False if already present."""
        try:
            self.insert_document(collection, doc)
            return True
        except DuplicateKeyError:
            return False

    def insert_many(self, collection: str, docs: Iterable[Mapping[str, Any]],
                    ignore_duplicates: bool = True) -> int:
        n = 0
        for doc in docs:
            if ignore_duplicates:
                n += int(self.insert_or_ignore(collection, doc))
            else:
                self.insert_document(collection, doc)
                n += 1
        return n

    def get_documents(self, collection: str,
                      doc_ids: Sequence[str]) -> dict[str, dict[str, Any]]:
        """Multi-get: ``{doc_id: doc}`` for the ids that exist (missing
        ids are simply absent — callers decide whether absence is an
        error). Drivers override with one round-trip; this default
        loops :meth:`get_document` so every backend keeps exact
        semantics."""
        out: dict[str, dict[str, Any]] = {}
        for doc_id in doc_ids:
            key = str(doc_id)
            if key in out:
                continue
            doc = self.get_document(collection, key)
            if doc is not None:
                out[key] = doc
        return out

    def update_documents(self, collection: str, doc_ids: Sequence[str],
                         updates: Mapping[str, Any]) -> int:
        """Bulk shallow-merge of the SAME updates into many docs;
        returns how many existed. Drivers override with one
        transaction; the default loops :meth:`update_document`."""
        n = 0
        seen: set[str] = set()
        for doc_id in doc_ids:
            key = str(doc_id)
            if key in seen:
                continue
            seen.add(key)
            n += int(self.update_document(collection, key, updates))
        return n

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()
