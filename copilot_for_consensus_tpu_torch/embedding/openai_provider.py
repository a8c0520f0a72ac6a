"""OpenAI-compatible ``/embeddings`` provider driver.

Covers the reference's ``OpenAIEmbeddingProvider``
(``copilot_embedding/openai_provider.py:20``) — and any endpoint
implementing the same API (Azure OpenAI, vLLM, Ollama compat, TEI) —
as an alternative to the first-party TPU encoder. stdlib-HTTP only;
zero-egress tests drive an in-process mock server. Real batching: one
request per ``embed_batch`` call, not one per text (the reference loops
``embed()`` per chunk — its own SLO bottleneck)."""

from __future__ import annotations

from typing import Any, Sequence

from copilot_for_consensus_tpu_torch.core.openai_compat import openai_post
from copilot_for_consensus_tpu_torch.embedding.base import (
    EmbeddingError,
    EmbeddingProvider,
    EmbeddingRateLimitError,
)


class OpenAIEmbeddingProvider(EmbeddingProvider):
    def __init__(self, base_url: str, *, api_key: str = "",
                 model: str = "text-embedding-3-small",
                 dimension: int = 1536, timeout_s: float = 30.0,
                 api_version: str = "", batch_size: int = 256):
        if not base_url:
            raise ValueError("openai embedding provider needs a base_url")
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self._dimension = dimension
        self.timeout_s = timeout_s
        self.api_version = api_version
        self.batch_size = batch_size

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def model_name(self) -> str:
        return self.model

    def _request(self, texts: Sequence[str]) -> list[list[float]]:
        out = openai_post(
            self.base_url, "/embeddings",
            {"model": self.model, "input": list(texts)},
            api_key=self.api_key, api_version=self.api_version,
            timeout_s=self.timeout_s, error_cls=EmbeddingError,
            rate_limit_cls=EmbeddingRateLimitError)
        try:
            rows: list[Any] = sorted(out["data"], key=lambda d: d["index"])
            vecs = [list(map(float, d["embedding"])) for d in rows]
        except (KeyError, TypeError) as exc:
            raise EmbeddingError(
                f"malformed embeddings response: {out!r:.300}") from exc
        if len(vecs) != len(texts):
            raise EmbeddingError(
                f"backend returned {len(vecs)} vectors for "
                f"{len(texts)} inputs")
        return vecs

    def embed(self, text: str) -> list[float]:
        return self._request([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        out: list[list[float]] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self._request(texts[i:i + self.batch_size]))
        return out
