"""Azure Cosmos DB (SQL API) document store — raw REST, no SDK.

The reference's ``AzureCosmosDocumentStore``
(``copilot_storage/azure_cosmos_document_store.py``, 1,077 LoC on the
Azure SDK) fills the cloud-production role next to Mongo; here the
driver speaks the Cosmos REST API directly with stdlib HTTP:

* **Auth**: master-key HMAC-SHA256 over the documented canonical string
  (verb, resource type, resource link, x-ms-date) — same zero-SDK
  approach as ``archive/azure_blob.py``.
* **Filters**: the store contract's Mongo-subset filters translate to
  parameterized Cosmos SQL (``translate_filter`` — equality, $ne, $in,
  $nin, $lt/$lte/$gt/$gte, $exists, $regex → RegexMatch, $or/$and,
  dotted paths). The translator is pure and unit-tested; the
  wire-contract mock in ``tests/test_azure_drivers.py`` evaluates the
  emitted SQL grammar, so filter → SQL → result round-trips are tested
  end-to-end without Cosmos.
* **Layout**: one container per collection (created lazily, 409
  tolerated), partition key ``/id``, the registry primary key mapped to
  Cosmos ``id``.

Usable against real Cosmos or its emulator wherever egress exists; this
image has neither, hence the wire-contract tests.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from email.utils import formatdate
from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.storage import registry
from copilot_for_consensus_tpu_torch.storage.base import (
    DocumentStore,
    DuplicateKeyError,
    StorageError,
)

_SQL_OPS = {"$lt": "<", "$lte": "<=", "$gt": ">", "$gte": ">="}


def sql_field(path: str) -> str:
    """Dotted path → ``c.a.b`` with the charset validated — shared by
    the filter translator and ORDER BY so neither can interpolate
    hostile text."""
    parts = str(path).split(".")
    if not all(p and all(c.isascii() and (c.isalnum() or c == "_")
                         for c in p) for p in parts):
        raise StorageError(f"unsupported field path {path!r}")
    return "c." + ".".join(parts)


def translate_filter(flt: Mapping[str, Any] | None
                     ) -> tuple[str, list[dict[str, Any]]]:
    """Mongo-subset filter → (WHERE clause, Cosmos parameters).

    Returns ``("", [])`` for an empty filter. Dotted paths become
    ``c.a.b``; every literal becomes an ``@pN`` parameter (never
    inlined — injection-safe by construction)."""
    params: list[dict[str, Any]] = []

    def bind(value: Any) -> str:
        name = f"@p{len(params)}"
        params.append({"name": name, "value": value})
        return name

    field = sql_field

    def condition(path: str, cond: Any) -> str:
        f = field(path)
        if isinstance(cond, Mapping) and any(
                str(k).startswith("$") for k in cond):
            terms = []
            for op, arg in cond.items():
                if op == "$exists":
                    terms.append(f"IS_DEFINED({f})" if arg
                                 else f"NOT IS_DEFINED({f})")
                elif op == "$in":
                    terms.append(
                        f"ARRAY_CONTAINS({bind(list(arg))}, {f})")
                elif op == "$nin":
                    terms.append(
                        f"NOT ARRAY_CONTAINS({bind(list(arg))}, {f})")
                elif op == "$regex":
                    terms.append(f"RegexMatch({f}, {bind(arg)})")
                elif op == "$ne":
                    # base-contract semantics: $ne MATCHES docs missing
                    # the field; bare != is undefined for them in Cosmos
                    terms.append(f"(NOT IS_DEFINED({f}) OR "
                                 f"{f} != {bind(arg)})")
                elif op in _SQL_OPS:
                    terms.append(f"{f} {_SQL_OPS[op]} {bind(arg)}")
                else:
                    raise StorageError(
                        f"unsupported filter operator {op!r}")
            return " AND ".join(terms)
        return f"{f} = {bind(cond)}"

    def clause(sub: Mapping[str, Any]) -> str:
        terms = []
        for key, cond in sub.items():
            if key == "$or":
                # empty $or matches nothing (any([]) in the base
                # contract); '()' would be an opaque Cosmos 400
                terms.append("(" + " OR ".join(
                    f"({clause(s)})" for s in cond) + ")"
                    if cond else "false")
            elif key == "$and":
                # empty $and is vacuously true (all([]))
                terms.append("(" + " AND ".join(
                    f"({clause(s)})" for s in cond) + ")"
                    if cond else "true")
            else:
                terms.append(condition(key, cond))
        return " AND ".join(terms) if terms else "true"

    if not flt:
        return "", params
    return clause(flt), params


class AzureCosmosDocumentStore(DocumentStore):
    API_VERSION = "2018-12-31"

    def __init__(self, account: str, master_key: str,
                 database: str = "copilot", *, endpoint: str = "",
                 timeout_s: float = 30.0):
        if not account or not master_key:
            raise ValueError("azure_cosmos needs account and master_key")
        self.account = account
        self.master_key = master_key
        self.database = database
        self.endpoint = (endpoint.rstrip("/")
                         or f"https://{account}.documents.azure.com")
        self.timeout_s = timeout_s
        self._known_colls: set[str] = set()
        self._connected = False

    # -- wire plumbing --------------------------------------------------

    def _auth(self, verb: str, resource_type: str, resource_link: str,
              date: str) -> str:
        payload = (f"{verb.lower()}\n{resource_type.lower()}\n"
                   f"{resource_link}\n{date.lower()}\n\n")
        sig = base64.b64encode(
            hmac.new(base64.b64decode(self.master_key),
                     payload.encode(), hashlib.sha256).digest()).decode()
        return urllib.parse.quote(
            f"type=master&ver=1.0&sig={sig}", safe="")

    def _request(self, verb: str, resource_type: str,
                 resource_link: str, path: str,
                 body: dict | None = None,
                 headers: dict[str, str] | None = None,
                 ok: tuple[int, ...] = (200, 201),
                 content_type: str = "application/json",
                 notfound_ok: bool = False
                 ) -> tuple[int, dict | None]:
        date = formatdate(time.time(), usegmt=True)
        hdrs = {
            "x-ms-date": date,
            "x-ms-version": self.API_VERSION,
            "Authorization": self._auth(verb, resource_type,
                                        resource_link, date),
            "Content-Type": content_type,
            **(headers or {}),
        }
        req = urllib.request.Request(
            f"{self.endpoint}/{path}", method=verb,
            data=json.dumps(body).encode() if body is not None else None,
            headers=hdrs)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None
        except urllib.error.HTTPError as exc:
            if exc.code in ok:
                raw = exc.read()
                return exc.code, json.loads(raw) if raw else None
            if exc.code == 409:
                raise DuplicateKeyError(
                    f"cosmos conflict on {path}") from exc
            if exc.code == 404 and notfound_ok:
                # Only reads/deletes may treat 404 as "absent" — a 404
                # on a WRITE (collection dropped externally) must raise,
                # not silently drop the document.
                return 404, None
            raise StorageError(
                f"cosmos {verb} {path} failed: HTTP {exc.code} "
                f"{exc.read()[:200].decode('utf-8', 'replace')}") from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise StorageError(f"cosmos unreachable: {exc}") from exc
        except json.JSONDecodeError as exc:
            raise StorageError(f"cosmos returned non-JSON: {exc}") from exc

    # -- lifecycle ------------------------------------------------------

    def connect(self) -> None:
        if self._connected:
            return
        try:
            self._request("POST", "dbs", "", "dbs",
                          {"id": self.database}, ok=(201,))
        except DuplicateKeyError:
            pass
        self._connected = True

    def close(self) -> None:
        self._connected = False

    def _coll_link(self, collection: str) -> str:
        return f"dbs/{self.database}/colls/{collection}"

    def _ensure_coll(self, collection: str) -> None:
        if collection in self._known_colls:
            return
        self.connect()
        try:
            self._request(
                "POST", "colls", f"dbs/{self.database}",
                f"dbs/{self.database}/colls",
                {"id": collection,
                 "partitionKey": {"paths": ["/id"], "kind": "Hash"}},
                ok=(201,))
        except DuplicateKeyError:
            pass
        self._known_colls.add(collection)

    # -- id mapping -----------------------------------------------------

    @staticmethod
    def _check_id(doc_id: str) -> str:
        # Cosmos forbids / \ ? # in ids; anything else URL-quotes for
        # the resource path. Reject the forbidden set at write time so a
        # stored document is never unreachable by id.
        doc_id = str(doc_id)
        if not doc_id or any(c in doc_id for c in "/\\?#"):
            raise StorageError(f"invalid cosmos document id {doc_id!r}")
        return doc_id

    @staticmethod
    def _quote_id(doc_id: str) -> str:
        return urllib.parse.quote(str(doc_id), safe="")

    def _key(self, collection: str, doc: Mapping[str, Any]) -> str:
        pk = registry.primary_key(collection)
        doc_id = doc.get(pk)
        if not doc_id:
            raise DuplicateKeyError(
                f"document for {collection!r} missing primary key {pk!r}")
        if "id" in doc and str(doc["id"]) != str(doc_id):
            # 'id' is the wire-level primary key this driver derives
            # from the registry pk; a conflicting user field would be
            # silently clobbered on write and popped on read.
            raise StorageError(
                "'id' is reserved by the cosmos driver (it mirrors the "
                f"registry primary key); got id={doc['id']!r} vs "
                f"pk={doc_id!r}")
        return self._check_id(doc_id)

    #: Cosmos-injected system properties — stripped on read so stored
    #: documents round-trip byte-identical (user keys like ``_id`` and
    #: arbitrary underscore-prefixed fields survive).
    _SYSTEM_PROPS = frozenset(
        {"_rid", "_ts", "_self", "_etag", "_attachments"})

    @classmethod
    def _strip(cls, doc: dict | None) -> dict | None:
        if doc is None:
            return None
        return {k: v for k, v in doc.items()
                if k not in cls._SYSTEM_PROPS}

    def _pk_header(self, doc_id: str) -> dict[str, str]:
        return {"x-ms-documentdb-partitionkey": json.dumps([doc_id])}

    # -- DocumentStore contract ----------------------------------------

    def insert_document(self, collection, doc):
        self._ensure_coll(collection)
        doc_id = self._key(collection, doc)
        body = {**dict(doc), "id": doc_id}
        self._request("POST", "docs", self._coll_link(collection),
                      f"{self._coll_link(collection)}/docs", body,
                      headers=self._pk_header(doc_id), ok=(201,))
        return doc_id

    def upsert_document(self, collection, doc):
        self._ensure_coll(collection)
        doc_id = self._key(collection, doc)
        body = {**dict(doc), "id": doc_id}
        self._request("POST", "docs", self._coll_link(collection),
                      f"{self._coll_link(collection)}/docs", body,
                      headers={**self._pk_header(doc_id),
                               "x-ms-documentdb-is-upsert": "true"},
                      ok=(200, 201))
        return doc_id

    def get_document(self, collection, doc_id):
        self._ensure_coll(collection)
        link = (f"{self._coll_link(collection)}/docs/"
                f"{self._quote_id(doc_id)}")
        raw_link = f"{self._coll_link(collection)}/docs/{doc_id}"
        status, doc = self._request("GET", "docs", raw_link, link,
                                    headers=self._pk_header(str(doc_id)),
                                    notfound_ok=True)
        if status == 404 or doc is None:
            return None
        doc.pop("id", None)
        return self._strip(doc)

    def query_documents(self, collection, flt=None, *, limit=None,
                        skip=0, sort=None):
        self._ensure_coll(collection)
        where, params = translate_filter(flt)
        sql = "SELECT * FROM c"
        if where:
            sql += f" WHERE {where}"
        if sort:
            sql += " ORDER BY " + ", ".join(
                f"{sql_field(f)} {'DESC' if d < 0 else 'ASC'}"
                for f, d in sort)
        if skip or limit is not None:
            sql += (f" OFFSET {int(skip)} LIMIT "
                    f"{int(limit) if limit is not None else 2**31 - 1}")
        docs = self._query_all(collection, sql, params)
        for d in docs:
            d.pop("id", None)
        return [self._strip(d) for d in docs]

    def _query_all(self, collection: str, sql: str,
                   params: list[dict]) -> list[dict]:
        """Run a query following x-ms-continuation until exhausted —
        real Cosmos pages results (default ~100/page); reading one page
        silently truncates."""
        out: list[dict] = []
        continuation: str | None = None
        while True:
            headers = {"x-ms-documentdb-isquery": "true",
                       "x-ms-documentdb-query-enablecrosspartition":
                           "true"}
            if continuation:
                headers["x-ms-continuation"] = continuation
            date = formatdate(time.time(), usegmt=True)
            link = self._coll_link(collection)
            req = urllib.request.Request(
                f"{self.endpoint}/{link}/docs", method="POST",
                data=json.dumps({"query": sql,
                                 "parameters": params}).encode(),
                headers={
                    "x-ms-date": date,
                    "x-ms-version": self.API_VERSION,
                    "Authorization": self._auth("POST", "docs", link,
                                                date),
                    "Content-Type": "application/query+json",
                    **headers,
                })
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    page = json.loads(resp.read() or b"{}")
                    continuation = resp.headers.get("x-ms-continuation")
            except urllib.error.HTTPError as exc:
                raise StorageError(
                    f"cosmos query failed: HTTP {exc.code} "
                    f"{exc.read()[:200].decode('utf-8', 'replace')}"
                ) from exc
            except (urllib.error.URLError, TimeoutError, OSError) as exc:
                raise StorageError(f"cosmos unreachable: {exc}") from exc
            out.extend(page.get("Documents", []))
            if not continuation:
                return out

    def update_document(self, collection, doc_id, updates):
        # Optimistic concurrency: merge onto the CURRENT revision and
        # replace with If-Match on its _etag; a concurrent writer gets
        # 412 and we re-read — no lost updates (sqlite's atomic UPDATE
        # equivalent for a remote store).
        self._ensure_coll(collection)
        for _ in range(8):
            link = (f"{self._coll_link(collection)}/docs/"
                    f"{self._quote_id(doc_id)}")
            raw_link = f"{self._coll_link(collection)}/docs/{doc_id}"
            status, current = self._request(
                "GET", "docs", raw_link, link,
                headers=self._pk_header(str(doc_id)), notfound_ok=True)
            if status == 404 or current is None:
                return False
            etag = current.get("_etag", "")
            merged = self._strip(current)
            merged.pop("id", None)
            merged.update(dict(updates))
            body = {**merged, "id": str(doc_id)}
            try:
                self._request("PUT", "docs", raw_link, link, body,
                              headers={**self._pk_header(str(doc_id)),
                                       "If-Match": etag},
                              ok=(200,))
                return True
            except StorageError as exc:
                if "HTTP 412" not in str(exc):
                    raise
        raise StorageError(
            f"update_document lost the etag race 8 times for "
            f"{collection}/{doc_id}")

    def delete_document(self, collection, doc_id):
        self._ensure_coll(collection)
        link = (f"{self._coll_link(collection)}/docs/"
                f"{self._quote_id(doc_id)}")
        raw_link = f"{self._coll_link(collection)}/docs/{doc_id}"
        status, _ = self._request("DELETE", "docs", raw_link, link,
                                  headers=self._pk_header(str(doc_id)),
                                  ok=(204,), notfound_ok=True)
        return status == 204

    def delete_documents(self, collection, flt=None):
        n = 0
        for doc in self.query_documents(collection, flt):
            pk = registry.primary_key(collection)
            if self.delete_document(collection, str(doc.get(pk))):
                n += 1
        return n

    def count_documents(self, collection, flt=None):
        self._ensure_coll(collection)
        where, params = translate_filter(flt)
        sql = "SELECT VALUE COUNT(1) FROM c"
        if where:
            sql += f" WHERE {where}"
        pages = self._query_all(collection, sql, params)
        # VALUE COUNT(1) returns one scalar per page/partition; sum them
        return int(sum(int(v) for v in pages)) if pages else 0
