"""NumPy exact-search vector store (tests and small corpora).

Keeps vectors L2-normalized in a contiguous matrix so query() is a single
matvec + argpartition — the same math the TPU driver runs on-device.
Scalar-equality metadata filters hit an inverted index (same design as
the TPU driver), so per-thread context queries are O(candidates), not
O(corpus); the vector buffer grows geometrically so adds are amortized
O(1) instead of a full copy each.
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any, Sequence

import numpy as np

from copilot_for_consensus_tpu_torch.storage.base import matches_filter
from copilot_for_consensus_tpu_torch.vectorstore._inverted import InvertedIndexMixin
from copilot_for_consensus_tpu_torch.vectorstore.base import (
    QueryResult,
    VectorStore,
    VectorStoreError,
)


class InMemoryVectorStore(InvertedIndexMixin, VectorStore):
    def __init__(self, config: Any = None):
        cfg = dict(config or {})
        self._dim: int | None = cfg.get("dimension") or None
        self._ids: list[str] = []
        self._index: dict[str, int] = {}
        self._vectors = np.zeros((0, self._dim or 1), dtype=np.float32)
        self._metadata: list[dict[str, Any]] = []
        self._init_inverted()
        self._lock = threading.RLock()
        self.persist_path = cfg.get("persist_path")

    @property
    def dimension(self) -> int | None:
        with self._lock:
            return self._dim

    @staticmethod
    def _normalize(vector: Sequence[float]) -> np.ndarray:
        arr = np.asarray(vector, dtype=np.float32)
        norm = float(np.linalg.norm(arr))
        return arr / norm if norm > 0 else arr

    @property
    def _n(self) -> int:
        with self._lock:
            return len(self._ids)

    def _grow_to(self, rows: int) -> None:
        cap = self._vectors.shape[0]
        if rows <= cap:
            return
        new_cap = max(rows, cap * 2, 64)
        grown = np.zeros((new_cap, self._dim), dtype=np.float32)
        grown[:self._n] = self._vectors[:self._n]
        self._vectors = grown

    def add_embedding(self, vec_id, vector, metadata=None):
        with self._lock:
            arr = self._normalize(vector)
            if self._dim is None:
                self._dim = arr.shape[0]
                self._vectors = np.zeros((0, self._dim), dtype=np.float32)
            if arr.shape[0] != self._dim:
                raise VectorStoreError(
                    f"dimension mismatch: store={self._dim} got={arr.shape[0]}")
            meta = dict(metadata or {})
            if vec_id in self._index:  # upsert
                row = self._index[vec_id]
                self._vectors[row] = arr
                self._index_meta(row, meta, remove=self._metadata[row])
                self._metadata[row] = meta
            else:
                row = self._n
                self._grow_to(row + 1)
                self._index[vec_id] = row
                self._ids.append(vec_id)
                self._vectors[row] = arr
                self._metadata.append(meta)
                self._index_meta(row, meta)

    def query(self, vector, top_k=10, flt=None):
        with self._lock:
            if not self._ids:
                return []
            q = self._normalize(vector)
            if flt:
                cand = self._matching_rows(flt)
                if not cand:
                    return []
                idx = np.asarray(cand)
                scores = self._vectors[idx] @ q
                k = min(top_k, len(cand))
                top = np.argpartition(-scores, k - 1)[:k]
                top = top[np.argsort(-scores[top])]
                return [QueryResult(self._ids[idx[i]], float(scores[i]),
                                    dict(self._metadata[idx[i]]))
                        for i in top]
            scores = self._vectors[:self._n] @ q
            k = min(top_k, self._n)
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top])]
            return [
                QueryResult(self._ids[i], float(scores[i]),
                            dict(self._metadata[i]))
                for i in top
            ]

    def _matching_rows(self, flt) -> list[int]:
        """Rows whose metadata matches ``flt``: index candidates
        re-verified with matches_filter (the index is a superset guess),
        or a full scan when the index can't decide the filter."""
        cand = self._filter_candidates(flt)
        if cand is None:
            return [i for i, m in enumerate(self._metadata)
                    if matches_filter(m, flt)]
        return [i for i in sorted(cand)
                if matches_filter(self._metadata[i], flt)]

    def get(self, vec_id):
        with self._lock:
            row = self._index.get(vec_id)
            if row is None:
                return None
            return self._vectors[row].tolist(), dict(self._metadata[row])

    def delete_by_filter(self, flt):
        with self._lock:
            doomed = [vid for vid, row in self._index.items()
                      if matches_filter(self._metadata[row], flt)]
        return self.delete(doomed)

    def delete(self, vec_ids):
        doomed = set(vec_ids)
        with self._lock:
            keep = [i for i, vid in enumerate(self._ids)
                    if vid not in doomed]
            removed = self._n - len(keep)
            self._ids = [self._ids[i] for i in keep]
            self._vectors = (self._vectors[keep] if keep
                             else np.zeros((0, self._dim or 1),
                                           dtype=np.float32))
            self._metadata = [self._metadata[i] for i in keep]
            self._index = {vid: i for i, vid in enumerate(self._ids)}
            self._init_inverted()
            for row, meta in enumerate(self._metadata):
                self._index_meta(row, meta)
            return removed

    def count(self):
        with self._lock:
            return self._n

    def clear(self):
        with self._lock:
            self._ids = []
            self._index = {}
            self._vectors = np.zeros((0, self._dim or 1), dtype=np.float32)
            self._metadata = []
            self._init_inverted()

    # -- persistence -------------------------------------------------------

    def save(self, path: str | pathlib.Path | None = None) -> None:
        path = pathlib.Path(path or self.persist_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            np.savez_compressed(
                path, vectors=self._vectors[:self._n],
                ids=np.array(self._ids, dtype=object),
                metadata=np.array(
                    [json.dumps(m) for m in self._metadata], dtype=object),
            )

    def load(self, path: str | pathlib.Path | None = None) -> None:
        path = pathlib.Path(path or self.persist_path)
        data = np.load(path, allow_pickle=True)
        with self._lock:
            self._vectors = data["vectors"].astype(np.float32)
            self._ids = [str(x) for x in data["ids"]]
            self._metadata = [json.loads(str(m)) for m in data["metadata"]]
            self._index = {vid: i for i, vid in enumerate(self._ids)}
            self._dim = self._vectors.shape[1] if len(self._ids) else None
            self._init_inverted()
            for row, meta in enumerate(self._metadata):
                self._index_meta(row, meta)
