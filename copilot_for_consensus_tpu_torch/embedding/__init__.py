"""Embedding-provider adapter (reference: ``adapters/copilot_embedding``).

Drivers: ``tpu`` (first-party EmbeddingEngine — the point of this
framework), ``mock`` (deterministic hash vectors for tests, parity with
``mock_provider.py:15``).
"""

from copilot_for_consensus_tpu_torch.embedding.base import (
    EmbeddingProvider,
    MockEmbeddingProvider,
)
from copilot_for_consensus_tpu_torch.embedding.factory import (
    create_embedding_provider,
)

__all__ = [
    "EmbeddingProvider",
    "MockEmbeddingProvider",
    "create_embedding_provider",
]
