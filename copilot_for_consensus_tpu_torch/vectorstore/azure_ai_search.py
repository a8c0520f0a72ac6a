"""Azure AI Search vector store — raw REST, no SDK.

Fills the role of the reference's
``copilot_vectorstore/azure_ai_search_store.py:32``
(AzureAISearchVectorStore: HNSW index provisioning ``:255``, vector
query with metadata, mergeOrUpload batching) with the documented
Search REST API and stdlib HTTP only, in the repo's Azure-driver
convention: the same requests work against real Azure AI Search or the
in-process wire-contract mock (``tests/test_azure_ai_search.py``).

Index shape (provisioned on connect, mirroring the reference's):

* ``id`` — key, filterable;
* ``embedding`` — ``Collection(Edm.Single)`` with the HNSW profile
  (m=4, efConstruction=400, efSearch=500, metric=cosine — the
  reference's constants ``azure_ai_search_store.py:23-29``);
* ``metadata`` — full metadata dict as one JSON string (retrievable);
* one filterable ``Edm.String`` field per configured
  ``filterable_keys`` entry — what makes server-side ``flt`` pushdown
  possible (the pipeline filters on ``thread_id``,
  ``services/orchestrator.py:130``).

Scores: AI Search reports ``@search.score = 1/(1 + d)`` with
``d = 1 - cosine``; the driver converts back to the base contract's
cosine-in-[-1, 1] (``vectorstore/base.py:24``).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Mapping, Sequence

from copilot_for_consensus_tpu_torch.vectorstore.base import (
    QueryResult,
    VectorStore,
    VectorStoreError,
)

API_VERSION = "2023-11-01"
# reference azure_ai_search_store.py:23-29
HNSW_M = 4
HNSW_EF_CONSTRUCTION = 400
HNSW_EF_SEARCH = 500

DEFAULT_FILTERABLE_KEYS = ("thread_id", "archive_id", "chunk_id",
                           "message_doc_id")


def _odata_quote(value: Any) -> str:
    return "'" + str(value).replace("'", "''") + "'"


def _odata_any_of(key: str, values: Sequence[Any]) -> str:
    """Membership as an eq-or chain. ``search.in`` would be fewer bytes
    but splits on its delimiter, silently mis-matching any value that
    contains it (ids are arbitrary strings per the base contract)."""
    return ("(" + " or ".join(
        f"{key} eq {_odata_quote(v)}" for v in values) + ")")


#: sentinel returned by _translate_filter for a filter that can match
#: nothing (empty $in) — callers short-circuit without a wire call
EMPTY_MATCH = object()


class AzureAISearchVectorStore(VectorStore):
    def __init__(self, config: Any = None):
        cfg = dict(config or {})
        self.endpoint = str(cfg.get("endpoint", "")).rstrip("/")
        self.api_key = str(cfg.get("api_key", ""))
        self.index_name = str(cfg.get("index_name", "embeddings"))
        self._dimension = int(cfg.get("dimension", 0))
        self.filterable_keys = tuple(
            cfg.get("filterable_keys") or DEFAULT_FILTERABLE_KEYS)
        self.timeout_s = float(cfg.get("timeout_s", 30.0))
        if not self.endpoint:
            raise ValueError("azure_ai_search needs endpoint")
        if not self.api_key:
            raise ValueError("azure_ai_search needs api_key")
        if self._dimension <= 0:
            raise ValueError(
                "azure_ai_search needs dimension > 0 (the index's "
                "vector field is fixed-size)")
        self._connected = False

    # -- wire plumbing --------------------------------------------------

    def _request(self, method: str, path: str,
                 body: dict | None = None,
                 ok: tuple[int, ...] = (200, 201, 204)
                 ) -> tuple[int, Any]:
        url = (f"{self.endpoint}{path}"
               f"{'&' if '?' in path else '?'}api-version={API_VERSION}")
        req = urllib.request.Request(
            url, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"api-key": self.api_key,
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                raw = resp.read()
                return resp.status, (json.loads(raw) if raw else None)
        except urllib.error.HTTPError as exc:
            if exc.code in ok:
                raw = exc.read()
                return exc.code, (json.loads(raw) if raw else None)
            detail = exc.read()[:200].decode("utf-8", "replace")
            raise VectorStoreError(
                f"ai_search {method} {path} failed: HTTP {exc.code} "
                f"{detail}") from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise VectorStoreError(
                f"ai_search unreachable at {self.endpoint}: {exc}"
            ) from exc

    # -- index lifecycle ------------------------------------------------

    def _index_definition(self) -> dict[str, Any]:
        fields: list[dict[str, Any]] = [
            {"name": "id", "type": "Edm.String", "key": True,
             "filterable": True},
            {"name": "embedding", "type": "Collection(Edm.Single)",
             "searchable": True, "dimensions": self._dimension,
             "vectorSearchProfile": "vp"},
            {"name": "metadata", "type": "Edm.String",
             "retrievable": True},
        ]
        fields += [{"name": k, "type": "Edm.String",
                    "filterable": True}
                   for k in self.filterable_keys]
        return {
            "name": self.index_name,
            "fields": fields,
            "vectorSearch": {
                "algorithms": [{
                    "name": "hnsw-algorithm", "kind": "hnsw",
                    "hnswParameters": {
                        "m": HNSW_M,
                        "efConstruction": HNSW_EF_CONSTRUCTION,
                        "efSearch": HNSW_EF_SEARCH,
                        "metric": "cosine",
                    },
                }],
                "profiles": [{"name": "vp",
                              "algorithm": "hnsw-algorithm"}],
            },
        }

    def connect(self) -> None:
        self._request(
            "PUT",
            f"/indexes/{urllib.parse.quote(self.index_name)}",
            self._index_definition())
        self._connected = True

    def _ensure(self) -> None:
        if not self._connected:
            self.connect()

    def _docs_path(self, suffix: str) -> str:
        return (f"/indexes/{urllib.parse.quote(self.index_name)}"
                f"/docs{suffix}")

    # -- write path -----------------------------------------------------

    def _to_doc(self, vec_id: str, vector: Sequence[float],
                metadata: Mapping[str, Any] | None) -> dict[str, Any]:
        if len(vector) != self._dimension:
            raise VectorStoreError(
                f"vector for {vec_id!r} has dimension {len(vector)}, "
                f"index expects {self._dimension}")
        md = dict(metadata or {})
        doc = {"@search.action": "mergeOrUpload", "id": str(vec_id),
               "embedding": [float(x) for x in vector],
               "metadata": json.dumps(md)}
        for k in self.filterable_keys:
            if k in md:
                doc[k] = str(md[k])
        return doc

    def add_embedding(self, vec_id, vector, metadata=None) -> None:
        self.add_embeddings([(vec_id, vector, metadata)])

    def add_embeddings(self, items) -> int:
        self._ensure()
        docs = [self._to_doc(i, v, m) for i, v, m in items]
        if not docs:
            return 0
        n = 0
        # the service caps batches at 1000 actions
        for start in range(0, len(docs), 1000):
            batch = docs[start:start + 1000]
            _, out = self._request("POST", self._docs_path("/index"),
                                   {"value": batch}, ok=(200, 207))
            for result in (out or {}).get("value", []):
                if not result.get("status", False):
                    raise VectorStoreError(
                        f"ai_search upsert failed for "
                        f"{result.get('key')!r}: "
                        f"{result.get('errorMessage')}")
                n += 1
        return n

    # -- read path ------------------------------------------------------

    def _translate_filter(self, flt: Mapping[str, Any] | None
                          ) -> str | None:
        """Base-contract filters → OData. Only keys promoted to
        filterable index fields can be pushed down; anything else is a
        loud error, not a silent wrong answer."""
        if not flt:
            return None
        terms = []
        for key, cond in flt.items():
            if key not in self.filterable_keys:
                raise VectorStoreError(
                    f"filter key {key!r} is not in filterable_keys "
                    f"{self.filterable_keys}; add it to the driver "
                    "config (re-indexing required)")
            if isinstance(cond, Mapping):
                if set(cond) == {"$in"}:
                    vals = [str(v) for v in cond["$in"]]
                    if not vals:
                        return EMPTY_MATCH   # sentinel: matches nothing
                    terms.append(_odata_any_of(key, vals))
                    continue
                raise VectorStoreError(
                    f"unsupported ai_search filter operator(s) "
                    f"{sorted(cond)} for {key!r} (supported: equality, "
                    "$in)")
            else:
                terms.append(f"{key} eq {_odata_quote(cond)}")
        return " and ".join(terms)

    @staticmethod
    def _score_to_cosine(score: float) -> float:
        # @search.score = 1 / (1 + d), d = 1 - cosine
        if score <= 0:
            return -1.0
        return 2.0 - 1.0 / score

    def query(self, vector, top_k=10, flt=None) -> list[QueryResult]:
        self._ensure()
        if len(vector) != self._dimension:
            raise VectorStoreError(
                f"query vector has dimension {len(vector)}, index "
                f"expects {self._dimension}")
        body: dict[str, Any] = {
            "search": "",
            "select": "id,metadata",
            "top": top_k,
            "vectorQueries": [{
                "kind": "vector",
                "vector": [float(x) for x in vector],
                "fields": "embedding",
                "k": top_k,
            }],
        }
        odata = self._translate_filter(flt)
        if odata is EMPTY_MATCH:
            return []
        if odata:
            body["filter"] = odata
        _, out = self._request("POST", self._docs_path("/search"), body)
        results = []
        for row in (out or {}).get("value", []):
            try:
                md = json.loads(row.get("metadata") or "{}")
            except ValueError:
                md = {}
            results.append(QueryResult(
                row["id"], self._score_to_cosine(
                    float(row["@search.score"])), md))
        return results

    def get(self, vec_id):
        self._ensure()
        # OData key literal: single quotes double FIRST, then
        # percent-encode — encoding alone would decode server-side into
        # a literal terminator and 400
        quoted = urllib.parse.quote(
            str(vec_id).replace("'", "''"), safe="")
        status, out = self._request(
            "GET", self._docs_path(f"('{quoted}')"), ok=(200, 404))
        if status == 404 or out is None:
            return None
        try:
            md = json.loads(out.get("metadata") or "{}")
        except ValueError:
            md = {}
        return [float(x) for x in out.get("embedding") or []], md

    def delete(self, vec_ids) -> int:
        """Delete by id; returns the number that existed.

        The count is BEST-EFFORT under the service's eventual
        consistency: the index API reports statusCode 200 for absent
        keys too, so existence is probed with a pre-delete search —
        documents added moments ago may not be searchable yet
        (under-count), and concurrent deleters can both observe a doc
        (double-count). Exact-count callers must serialize externally.
        """
        self._ensure()
        ids = [str(i) for i in vec_ids]
        if not ids:
            return 0
        existing = 0
        for start in range(0, len(ids), 64):
            chunk = ids[start:start + 64]
            _, out = self._request(
                "POST", self._docs_path("/search"),
                {"search": "", "filter": _odata_any_of("id", chunk),
                 "select": "id", "top": len(chunk), "count": True})
            existing += int((out or {}).get("@odata.count",
                                            len((out or {}).get(
                                                "value", []))))
        actions = [{"@search.action": "delete", "id": i} for i in ids]
        self._request("POST", self._docs_path("/index"),
                      {"value": actions}, ok=(200, 207))
        return existing

    def delete_by_filter(self, flt) -> int:
        self._ensure()
        odata = self._translate_filter(flt)
        if odata is EMPTY_MATCH:
            return 0
        # the service indexes asynchronously: a search issued right
        # after a delete batch can still return the same ids. Count
        # UNIQUE ids and stop when a round surfaces nothing new, so
        # eventual consistency can neither over-report nor spin forever.
        seen: set[str] = set()
        while True:
            _, out = self._request(
                "POST", self._docs_path("/search"),
                {"search": "", "filter": odata, "select": "id",
                 "top": 1000})
            ids = [row["id"] for row in (out or {}).get("value", [])]
            fresh = [i for i in ids if i not in seen]
            if not fresh:
                return len(seen)
            seen.update(fresh)
            self._request(
                "POST", self._docs_path("/index"),
                {"value": [{"@search.action": "delete", "id": i}
                           for i in fresh]}, ok=(200, 207))

    def count(self) -> int:
        self._ensure()
        _, out = self._request("GET", self._docs_path("/$count"))
        return int(out)

    def clear(self) -> None:
        self._request(
            "DELETE",
            f"/indexes/{urllib.parse.quote(self.index_name)}",
            ok=(200, 204, 404))
        self._connected = False
        self.connect()

    @property
    def dimension(self) -> int | None:
        return self._dimension
