"""SQLite document store: the durable single-host driver.

One table per collection (``id TEXT PRIMARY KEY, doc TEXT`` JSON), WAL mode
for concurrent reader/writer services. Fills the durable-store role the
reference delegates to MongoDB (``mongo_document_store.py:33``) without an
external process — including its index story: the Mongo driver declares
per-collection indexes on the hot filter fields
(``mongo_document_store.py:33``); here the same fields get SQLite
*expression indexes* over ``json_extract(doc, '$.field')``, and the
Mongo-style filter subset compiles to SQL ``WHERE`` clauses that use them.
Queries the compiler can't express exactly (``$regex``, ``None`` inside
``$in`` lists, exotic paths) fall back to the shared Python matcher, so
semantics never change — only the plan does.

Known divergences from the Python matcher, both outside the pipeline's
data contract: (a) mixed-type range comparisons raise TypeError in Python
but exclude the row in SQL; (b) strings containing U+0000 are truncated
at the NUL by SQLite's json_extract (C-string semantics), so ``"a\\x00b"``
compares as ``"a"`` in SQL — no pipeline stage writes NULs into documents.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re
import sqlite3
import threading
from typing import Any, Callable, Mapping, Sequence

from copilot_for_consensus_tpu_torch.storage import registry
from copilot_for_consensus_tpu_torch.storage.base import (
    DocumentStore,
    DuplicateKeyError,
    StorageContentionError,
    StorageError,
    matches_filter,
    sort_documents,
)


def _transient_locks(fn: Callable) -> Callable:
    """Translate sqlite lock contention (``SQLITE_BUSY``/``SQLITE_LOCKED``
    surfacing as ``OperationalError: database is locked`` past the busy
    timeout under concurrent writer services) into the retryable
    :class:`StorageContentionError`, so the service retry policy backs
    off and the lease/redelivery path applies instead of the envelope
    being classified as poison."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except sqlite3.OperationalError as exc:
            msg = str(exc).lower()
            if "locked" in msg or "busy" in msg:
                raise StorageContentionError(str(exc)) from exc
            raise

    return wrapper

_TABLE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_PATH_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")

# Hot filter/sort fields per collection → expression indexes, mirroring the
# role of the reference Mongo driver's per-collection index declarations
# (``mongo_document_store.py:33``). Extra entries are harmless; missing ones
# only cost a scan.
INDEX_FIELDS: dict[str, tuple[str, ...]] = {
    "archives": ("source_id", "status"),
    "messages": ("thread_id", "source_id", "archive_id", "status"),
    "threads": ("source_id", "status"),
    "chunks": ("thread_id", "source_id", "message_doc_id",
               "embedding_generated", "seq"),
    "summaries": ("thread_id", "source_id", "status"),
    "reports": ("thread_id", "summary_id", "status", "published_at"),
    "sources": ("enabled",),
}


def _ex(path: str) -> str:
    """The indexed extraction expression for a validated dotted path.
    (Primary-key paths never reach here: _compile_pk_condition maps them
    to the ``id`` PRIMARY KEY column first — a B-tree lookup instead of
    a full-table json_extract scan for the hot ``chunk_id: {"$in":
    [...]}`` queries every pipeline stage issues.)"""
    return f"json_extract(doc, '$.{path}')"


def _ty(path: str) -> str:
    return f"json_type(doc, '$.{path}')"


class _Incompatible(Exception):
    """Filter/sort shape the SQL compiler can't express exactly."""


def _compile_pk_condition(cond: Any, params: list) -> str | None:
    """Primary-key fast path onto the ``id`` column (B-tree lookup).
    Only string comparisons are safe — ``id`` holds ``str(doc_id)``
    while the JSON copy keeps the original type — so anything else
    returns None and takes the json_extract path."""
    if isinstance(cond, str):
        params.append(cond)
        return "id = ?"
    if isinstance(cond, Mapping) and cond and all(
            k in ("$in", "$nin", "$ne") for k in cond):
        clauses = []
        local: list = []
        for op, arg in cond.items():
            if op == "$ne":
                if not isinstance(arg, str):
                    return None
                local.append(arg)
                clauses.append("id != ?")
                continue
            vals = list(arg)
            if not all(isinstance(v, str) for v in vals):
                return None
            if not vals:
                # $in []: never matches; $nin []: pk always exists.
                clauses.append("0" if op == "$in" else "1")
                continue
            marks = ",".join("?" for _ in vals)
            local.extend(vals)
            clauses.append(f"id {'IN' if op == '$in' else 'NOT IN'} "
                           f"({marks})")
        params.extend(local)
        return "(" + " AND ".join(clauses) + ")"
    return None


def _compile_condition(path: str, cond: Any, params: list,
                       pk: str | None = None) -> str:
    if pk is not None and path == pk:
        fast = _compile_pk_condition(cond, params)
        if fast is not None:
            return fast
    if not _PATH_RE.match(path):
        raise _Incompatible(path)
    if isinstance(cond, Mapping) and any(k.startswith("$") for k in cond):
        clauses = []
        for op, arg in cond.items():
            if op == "$exists":
                clauses.append(f"{_ty(path)} IS " +
                               ("NOT NULL" if arg else "NULL"))
            elif op == "$ne":
                if arg is None:
                    clauses.append(f"({_ty(path)} IS NOT NULL "
                                   f"AND {_ty(path)} != 'null')")
                elif not isinstance(arg, (str, int, float, bool)):
                    raise _Incompatible(op)
                else:
                    params.append(arg)
                    clauses.append(f"({_ex(path)} IS NULL "
                                   f"OR {_ex(path)} != ?)")
            elif op in ("$in", "$nin"):
                vals = list(arg)
                if any(v is None for v in vals) or not all(
                        isinstance(v, (str, int, float, bool)) for v in vals):
                    raise _Incompatible(op)
                if not vals:
                    # Matcher: $in [] never matches; $nin [] matches any
                    # doc whose field exists ('NOT IN (NULL)' would be
                    # NULL → reject-all, so special-case both).
                    clauses.append("0" if op == "$in"
                                   else f"{_ty(path)} IS NOT NULL")
                    continue
                marks = ",".join("?" for _ in vals)
                params.extend(vals)
                if op == "$in":
                    clauses.append(f"{_ex(path)} IN ({marks})")
                else:
                    clauses.append(
                        f"({_ty(path)} IS NOT NULL AND ({_ty(path)}='null' "
                        f"OR {_ex(path)} NOT IN ({marks})))")
            elif op in ("$lt", "$lte", "$gt", "$gte"):
                if not isinstance(arg, (str, int, float)) or isinstance(
                        arg, bool):
                    raise _Incompatible(op)
                sql_op = {"$lt": "<", "$lte": "<=",
                          "$gt": ">", "$gte": ">="}[op]
                # Type guard: the Python matcher raises TypeError on a
                # str-vs-number comparison; SQL can't raise, so mixed-type
                # rows are excluded instead of silently type-ordered.
                # Python bools ARE ints, so they stay comparable to numbers.
                want = ("'text'" if isinstance(arg, str)
                        else "'integer','real','true','false'")
                params.append(arg)
                clauses.append(f"({_ty(path)} IN ({want}) "
                               f"AND {_ex(path)} {sql_op} ?)")
            else:  # $regex and anything unknown → Python matcher
                raise _Incompatible(op)
        return "(" + " AND ".join(clauses) + ")"
    # Plain equality.
    if cond is None:
        return f"{_ty(path)} = 'null'"
    if not isinstance(cond, (str, int, float, bool)):
        raise _Incompatible(type(cond).__name__)
    params.append(cond)
    return f"{_ex(path)} = ?"


def _compile_filter(flt: Mapping[str, Any] | None, params: list,
                    pk: str | None = None) -> str:
    """Compile the Mongo-subset filter to a WHERE expression with exactly the
    semantics of :func:`matches_filter`; raises _Incompatible otherwise."""
    if not flt:
        return "1"
    clauses = []
    for key, cond in flt.items():
        if key == "$or":
            subs = [_compile_filter(sub, params, pk) for sub in cond]
            clauses.append("(" + " OR ".join(subs or ["0"]) + ")")
        elif key == "$and":
            subs = [_compile_filter(sub, params, pk) for sub in cond]
            clauses.append("(" + " AND ".join(subs or ["1"]) + ")")
        elif key.startswith("$"):
            raise _Incompatible(key)
        else:
            clauses.append(_compile_condition(key, cond, params, pk))
    return "(" + " AND ".join(clauses) + ")"


def _compile_sort(sort: Sequence[tuple[str, int]] | None) -> str:
    """ORDER BY matching sort_documents: ascending puts None last,
    descending (full reverse) puts None first; rowid breaks ties in
    insertion order like Python's stable sort."""
    if not sort:
        # Match the fallback/memory stores' insertion order (rowid order);
        # without this, an index scan would return rows grouped by key.
        return " ORDER BY rowid ASC"
    terms = []
    for field_name, direction in sort:
        if not _PATH_RE.match(field_name):
            raise _Incompatible(field_name)
        d = "DESC" if direction < 0 else "ASC"
        terms.append(f"{_ex(field_name)} IS NULL {d}, {_ex(field_name)} {d}")
    return " ORDER BY " + ", ".join(terms) + ", rowid ASC"


class SQLiteDocumentStore(DocumentStore):
    def __init__(self, config: Any = None):
        cfg = dict(config or {})
        self.path = cfg.get("path", "var/documents.sqlite3")
        self._local = threading.local()
        self._known_tables: set[str] = set()
        self._lock = threading.Lock()

    # -- connection management (one sqlite connection per thread) ----------

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.path != ":memory:":
                pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _table(self, collection: str) -> str:
        if not _TABLE_RE.match(collection):
            raise StorageError(f"invalid collection name {collection!r}")
        table = f"docs_{collection}"
        if table not in self._known_tables:
            with self._lock:
                self._conn().execute(
                    f"CREATE TABLE IF NOT EXISTS {table} "
                    "(id TEXT PRIMARY KEY, doc TEXT NOT NULL)"
                )
                for field_name in INDEX_FIELDS.get(collection, ()):
                    self._conn().execute(
                        f"CREATE INDEX IF NOT EXISTS "
                        f"idx_{collection}_{field_name} ON {table} "
                        f"({_ex(field_name)})")
                self._conn().commit()
                self._known_tables.add(table)
        return table

    def _key(self, collection: str, doc: Mapping[str, Any]) -> str:
        pk = registry.primary_key(collection)
        doc_id = doc.get(pk)
        if not doc_id:
            raise DuplicateKeyError(
                f"document for {collection!r} missing primary key {pk!r}")
        return str(doc_id)

    # -- CRUD --------------------------------------------------------------

    @_transient_locks
    def insert_document(self, collection, doc):
        table = self._table(collection)
        doc_id = self._key(collection, doc)
        try:
            self._conn().execute(
                f"INSERT INTO {table} (id, doc) VALUES (?, ?)",
                (doc_id, json.dumps(dict(doc))),
            )
            self._conn().commit()
        except sqlite3.IntegrityError as exc:
            raise DuplicateKeyError(f"{collection}/{doc_id} exists") from exc
        return doc_id

    @_transient_locks
    def upsert_document(self, collection, doc):
        table = self._table(collection)
        doc_id = self._key(collection, doc)
        self._conn().execute(
            f"INSERT INTO {table} (id, doc) VALUES (?, ?) "
            "ON CONFLICT(id) DO UPDATE SET doc=excluded.doc",
            (doc_id, json.dumps(dict(doc))),
        )
        self._conn().commit()
        return doc_id

    @_transient_locks
    def get_document(self, collection, doc_id):
        table = self._table(collection)
        row = self._conn().execute(
            f"SELECT doc FROM {table} WHERE id=?", (str(doc_id),)
        ).fetchone()
        return json.loads(row[0]) if row else None

    # sqlite's bound-parameter ceiling (SQLITE_MAX_VARIABLE_NUMBER,
    # 999 in older builds): bulk IN()/executemany batches stay under it
    _BULK_CHUNK = 500

    @_transient_locks
    def get_documents(self, collection, doc_ids):
        """One ``IN (...)`` B-tree probe per 500 ids instead of one
        round-trip per id — the multi-get the batched stage hot paths
        (chunking/parsing waves) ride."""
        table = self._table(collection)
        ids = []
        seen: set[str] = set()
        for doc_id in doc_ids:
            key = str(doc_id)
            if key not in seen:
                seen.add(key)
                ids.append(key)
        out: dict[str, dict] = {}
        conn = self._conn()
        for start in range(0, len(ids), self._BULK_CHUNK):
            chunk = ids[start:start + self._BULK_CHUNK]
            marks = ",".join("?" for _ in chunk)
            for doc_id, raw in conn.execute(
                    f"SELECT id, doc FROM {table} WHERE id IN ({marks})",
                    chunk):
                out[doc_id] = json.loads(raw)
        return out

    @_transient_locks
    def insert_many(self, collection, docs, ignore_duplicates=True):
        """One transaction for the whole wave. With
        ``ignore_duplicates`` the insert is ``OR IGNORE`` (the
        dup-key-tolerant chunk-insert contract); without it the first
        duplicate raises :class:`DuplicateKeyError` and nothing from
        the batch commits."""
        table = self._table(collection)
        rows = [(self._key(collection, d), json.dumps(dict(d)))
                for d in docs]
        if not rows:
            return 0
        conn = self._conn()
        verb = "INSERT OR IGNORE" if ignore_duplicates else "INSERT"
        n = 0
        try:
            for start in range(0, len(rows), self._BULK_CHUNK):
                chunk = rows[start:start + self._BULK_CHUNK]
                cur = conn.executemany(
                    f"{verb} INTO {table} (id, doc) VALUES (?, ?)", chunk)
                # OR IGNORE: rowcount counts only rows actually inserted
                n += max(0, cur.rowcount)
        except sqlite3.IntegrityError as exc:
            conn.rollback()
            raise DuplicateKeyError(
                f"duplicate key in {collection} bulk insert") from exc
        conn.commit()
        return n

    @_transient_locks
    def update_documents(self, collection, doc_ids, updates):
        """Bulk same-fields merge in ONE transaction under the writer
        lock — the ``chunked: True`` flag-flip a wave of messages pays
        once instead of per message."""
        table = self._table(collection)
        ids = []
        seen: set[str] = set()
        for doc_id in doc_ids:
            key = str(doc_id)
            if key not in seen:
                seen.add(key)
                ids.append(key)
        if not ids:
            return 0
        fields = dict(updates)
        conn = self._conn()
        n = 0
        with self._lock:
            for start in range(0, len(ids), self._BULK_CHUNK):
                chunk = ids[start:start + self._BULK_CHUNK]
                marks = ",".join("?" for _ in chunk)
                rows = conn.execute(
                    f"SELECT id, doc FROM {table} WHERE id IN ({marks})",
                    chunk).fetchall()
                merged = []
                for doc_id, raw in rows:
                    doc = json.loads(raw)
                    doc.update(fields)
                    merged.append((json.dumps(doc), doc_id))
                if merged:
                    conn.executemany(
                        f"UPDATE {table} SET doc=? WHERE id=?", merged)
                    n += len(merged)
            conn.commit()
        return n

    def _iter_docs(self, collection):
        table = self._table(collection)
        for (raw,) in self._conn().execute(f"SELECT doc FROM {table}"):
            yield json.loads(raw)

    def _python_query(self, collection, flt, *, limit=None, skip=0,
                      sort=None):
        """Fallback path: full scan + the shared Python matcher — used
        for filter shapes the compiler can't express and for parameter
        values sqlite can't bind (lone surrogates in filter strings)."""
        docs = [d for d in self._iter_docs(collection)
                if matches_filter(d, flt)]
        sort_documents(docs, sort)
        if skip:
            docs = docs[skip:]
        if limit is not None:
            docs = docs[:limit]
        return docs

    @_transient_locks
    def query_documents(self, collection, flt=None, *, limit=None, skip=0,
                        sort: Sequence[tuple[str, int]] | None = None):
        table = self._table(collection)
        try:
            params: list = []
            where = _compile_filter(flt, params,
                                    registry.primary_key(collection))
            order = _compile_sort(sort)
        except _Incompatible:
            return self._python_query(collection, flt, limit=limit,
                                      skip=skip, sort=sort)
        sql = f"SELECT doc FROM {table} WHERE {where}{order}"
        if limit is not None or skip:
            sql += " LIMIT ? OFFSET ?"
            params.extend([-1 if limit is None else limit, skip])
        try:
            return [json.loads(raw) for (raw,)
                    in self._conn().execute(sql, params)]
        except UnicodeEncodeError:
            return self._python_query(collection, flt, limit=limit,
                                      skip=skip, sort=sort)

    @_transient_locks
    def update_document(self, collection, doc_id, updates):
        table = self._table(collection)
        conn = self._conn()
        with self._lock:
            row = conn.execute(
                f"SELECT doc FROM {table} WHERE id=?", (str(doc_id),)
            ).fetchone()
            if row is None:
                return False
            doc = json.loads(row[0])
            doc.update(dict(updates))
            conn.execute(
                f"UPDATE {table} SET doc=? WHERE id=?",
                (json.dumps(doc), str(doc_id)),
            )
            conn.commit()
            return True

    @_transient_locks
    def delete_document(self, collection, doc_id):
        table = self._table(collection)
        cur = self._conn().execute(
            f"DELETE FROM {table} WHERE id=?", (str(doc_id),))
        self._conn().commit()
        return cur.rowcount > 0

    def _python_delete(self, collection, flt):
        table = self._table(collection)
        ids = [str(d[registry.primary_key(collection)])
               for d in self._iter_docs(collection)
               if matches_filter(d, flt)]
        for doc_id in ids:
            self._conn().execute(
                f"DELETE FROM {table} WHERE id=?", (doc_id,))
        self._conn().commit()
        return len(ids)

    @_transient_locks
    def delete_documents(self, collection, flt=None):
        table = self._table(collection)
        try:
            params: list = []
            where = _compile_filter(flt, params,
                                    registry.primary_key(collection))
        except _Incompatible:
            return self._python_delete(collection, flt)
        try:
            cur = self._conn().execute(
                f"DELETE FROM {table} WHERE {where}", params)
        except UnicodeEncodeError:
            return self._python_delete(collection, flt)
        self._conn().commit()
        return cur.rowcount

    @_transient_locks
    def count_documents(self, collection, flt=None):
        table = self._table(collection)
        try:
            params: list = []
            where = _compile_filter(flt, params,
                                    registry.primary_key(collection))
        except _Incompatible:
            return sum(1 for d in self._iter_docs(collection)
                       if matches_filter(d, flt))
        try:
            return self._conn().execute(
                f"SELECT COUNT(*) FROM {table} WHERE {where}",
                params).fetchone()[0]
        except UnicodeEncodeError:
            return sum(1 for d in self._iter_docs(collection)
                       if matches_filter(d, flt))
