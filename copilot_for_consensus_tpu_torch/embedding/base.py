"""EmbeddingProvider ABC + mock driver.

Interface parity with the reference ABC
(``copilot_embedding/base.py:12-25``: ``embed(text) -> list[float]``),
extended with the batched call the reference lacks — its embedding
service loops ``embed()`` per text (``embedding/app/service.py:393``);
our services call ``embed_batch`` and get real cross-text batching.
"""

from __future__ import annotations

import abc
import hashlib
import math
from typing import Sequence


class EmbeddingError(Exception):
    pass


from copilot_for_consensus_tpu_torch.core.retry import (  # noqa: E402
    RetryableError as _RetryableError,
)


class EmbeddingRateLimitError(EmbeddingError, _RetryableError):
    """Backend 429: transient by definition. Also a RetryableError, so
    the service retry loop backs off and re-attempts instead of
    terminally failing the document's embedding."""

    def __init__(self, message: str = "", retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class EmbeddingProvider(abc.ABC):
    @property
    @abc.abstractmethod
    def dimension(self) -> int: ...

    @property
    def model_name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def embed(self, text: str) -> list[float]: ...

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        return [self.embed(t) for t in texts]


class MockEmbeddingProvider(EmbeddingProvider):
    """Deterministic, normalized hash vectors. Texts sharing words get
    correlated vectors, so top-k retrieval behaves sensibly in tests."""

    def __init__(self, dimension: int = 32):
        self._dim = dimension

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def model_name(self) -> str:
        return "mock"

    def embed(self, text: str) -> list[float]:
        vec = [0.0] * self._dim
        for word in (text or "").lower().split():
            h = hashlib.sha1(word.encode()).digest()
            idx = int.from_bytes(h[:4], "big") % self._dim
            sign = 1.0 if h[4] % 2 else -1.0
            vec[idx] += sign
        norm = math.sqrt(sum(x * x for x in vec)) or 1.0
        return [x / norm for x in vec]
