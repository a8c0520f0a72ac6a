"""VectorStore ABC."""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Sequence


class VectorStoreError(Exception):
    pass


@dataclass
class QueryResult:
    id: str
    score: float
    metadata: dict[str, Any] = field(default_factory=dict)


class VectorStore(abc.ABC):
    """Embedding storage with upsert semantics and metadata-filtered top-k.

    Scores are cosine similarity in [-1, 1]; higher is better.
    """

    def connect(self) -> None:
        pass

    def close(self) -> None:
        pass

    def set_metrics(self, collector: Any) -> None:
        """Wire a MetricsCollector so the store can emit retrieval
        telemetry (``vectorstore_*`` series). Default: drop it —
        drivers without native metrics stay silent."""

    @abc.abstractmethod
    def add_embedding(self, vec_id: str, vector: Sequence[float],
                      metadata: Mapping[str, Any] | None = None) -> None: ...

    def add_embeddings(self, items: Iterable[tuple[str, Sequence[float],
                                                   Mapping[str, Any] | None]]) -> int:
        n = 0
        for vec_id, vector, metadata in items:
            self.add_embedding(vec_id, vector, metadata)
            n += 1
        return n

    @abc.abstractmethod
    def query(self, vector: Sequence[float], top_k: int = 10,
              flt: Mapping[str, Any] | None = None) -> list[QueryResult]: ...

    def query_batch(self, vectors: Sequence[Sequence[float]],
                    top_k: int = 10,
                    flt: Mapping[str, Any] | None = None
                    ) -> list[list[QueryResult]]:
        """Many queries at once. The base implementation loops; device
        drivers override it with one fused dispatch — on hardware where
        each dispatch costs a host↔device round trip, this is the
        difference between latency-bound and compute-bound search."""
        return [self.query(v, top_k, flt) for v in vectors]

    @abc.abstractmethod
    def get(self, vec_id: str) -> tuple[list[float], dict[str, Any]] | None: ...

    @abc.abstractmethod
    def delete(self, vec_ids: Sequence[str]) -> int: ...

    def delete_by_filter(self, flt: Mapping[str, Any]) -> int:
        """Delete every vector whose metadata matches ``flt``. Drivers
        that can't filter server-side may override or raise."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support filtered deletion")

    @abc.abstractmethod
    def count(self) -> int: ...

    @abc.abstractmethod
    def clear(self) -> None: ...

    @property
    @abc.abstractmethod
    def dimension(self) -> int | None:
        """Vector dimension, or None until the first vector is added."""
