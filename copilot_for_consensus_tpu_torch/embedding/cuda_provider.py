"""The port's first-party encoder behind the embedding adapter interface
(port of the JAX package's ``TPUEmbeddingProvider``,
``embedding/base.py:79-118``): ``CUDAEmbeddingProvider`` wraps the port's
``EmbeddingEngine`` — K1 and ``torch.matmul`` on the card, unless
``device="cpu"`` is asked for.

``embed_batch(texts)`` keeps the reference provider's signature, so the
copied ``EmbeddingService`` (which probes it for ``tenant``) passes no
tenant here, as it passes none to the JAX package's provider.
"""

from __future__ import annotations

from typing import Sequence

from copilot_for_consensus_tpu_torch.embedding.base import EmbeddingProvider


class CUDAEmbeddingProvider(EmbeddingProvider):
    """First-party encoder on the card behind the adapter interface."""

    def __init__(self, model: str = "minilm-l6", *, params=None, mesh=None,
                 tokenizer=None, batch_size: int = 64, dtype=None,
                 checkpoint: str | None = None, attn_impl: str = "auto",
                 device=None):
        from copilot_for_consensus_tpu_torch.engine.embedding import (
            EmbeddingEngine,
        )
        from copilot_for_consensus_tpu_torch.models import encoder_config

        if checkpoint is not None:
            # real weights (a BERT/MiniLM-family HF directory)
            self._engine = EmbeddingEngine.from_checkpoint(
                checkpoint, mesh=mesh, tokenizer=tokenizer,
                batch_size=batch_size, attn_impl=attn_impl, device=device)
            self._model = f"checkpoint:{checkpoint}"
        else:
            self._engine = EmbeddingEngine(
                encoder_config(model), params, mesh=mesh,
                tokenizer=tokenizer, batch_size=batch_size,
                dtype=dtype or "bfloat16", attn_impl=attn_impl,
                device=device)
            self._model = model

    @property
    def engine(self):
        return self._engine

    @property
    def dimension(self) -> int:
        return self._engine.dimension

    @property
    def model_name(self) -> str:
        return f"cuda:{self._model}"

    def embed(self, text: str) -> list[float]:
        return self._engine.embed(text)

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        return self._engine.embed_batch(texts).tolist()
