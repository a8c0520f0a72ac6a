"""Embedding driver registry + factory (port of the JAX package's
``embedding/factory.py``).

Drivers: ``mock`` (deterministic hash vectors), ``cuda`` (the port's
encoder engine, ``CUDAEmbeddingProvider``; ``device`` from the config,
None meaning the card), ``openai`` and ``azure_openai``. The JAX
package's ``tpu`` driver is refused with a pointer to ``cuda``.
"""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.core.openai_compat import (
    azure_default_api_version,
)
from copilot_for_consensus_tpu_torch.embedding.base import (
    EmbeddingProvider,
    MockEmbeddingProvider,
)


def _cfg_get(config: Any, key: str, default=None):
    if config is None:
        return default
    if isinstance(config, dict):
        return config.get(key, default)
    return getattr(config, key, default)


def create_embedding_provider(config: Any = None) -> EmbeddingProvider:
    driver = _cfg_get(config, "driver", "mock")
    if driver == "mock":
        return MockEmbeddingProvider(
            dimension=int(_cfg_get(config, "dimension", 32)))
    if driver == "tpu":
        raise ValueError(
            "embedding driver 'tpu' is the JAX package's; the port's "
            "encoder-backed driver is 'cuda'")
    if driver == "cuda":
        from copilot_for_consensus_tpu_torch.embedding.cuda_provider import (
            CUDAEmbeddingProvider,
        )

        return CUDAEmbeddingProvider(
            model=_cfg_get(config, "model", "minilm-l6"),
            checkpoint=_cfg_get(config, "checkpoint") or None,
            batch_size=int(_cfg_get(config, "batch_size", 64)),
            device=_cfg_get(config, "device"))
    if driver in ("openai", "azure_openai"):
        from copilot_for_consensus_tpu_torch.embedding.openai_provider import (
            OpenAIEmbeddingProvider,
        )

        return OpenAIEmbeddingProvider(
            base_url=_cfg_get(config, "base_url", ""),
            api_key=_cfg_get(config, "api_key", "") or "",
            model=_cfg_get(config, "model", "text-embedding-3-small"),
            dimension=int(_cfg_get(config, "dimension", 1536)),
            api_version=azure_default_api_version(
                driver, _cfg_get(config, "api_version", "")),
            batch_size=int(_cfg_get(config, "batch_size", 256)))
    raise ValueError(f"unknown embedding driver {driver!r}")


register_driver("embedding_backend", "mock", create_embedding_provider)
register_driver("embedding_backend", "cuda", create_embedding_provider)
register_driver("embedding_backend", "openai", create_embedding_provider)
register_driver("embedding_backend", "azure_openai",
                create_embedding_provider)
