"""Vector store driver registration + create_vector_store (port of the
JAX package's ``vectorstore/factory.py``).

Drivers: ``memory``, ``cuda`` (``CUDAVectorStore``: flat and IVF search
on the card; ``device`` from the config, None meaning the card),
``native`` (the host C++ flat index, a copy of the JAX package's) and
``azure_ai_search``. The JAX package's ``tpu`` driver is refused with a
pointer to ``cuda``.
"""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.vectorstore.memory import (
    InMemoryVectorStore,
)


def create_vector_store(config: Any = None):
    cfg = dict(config or {})
    driver = cfg.get("driver", "memory")
    if driver == "memory":
        return InMemoryVectorStore(cfg)
    if driver == "tpu":
        raise ValueError(
            "vector_store driver 'tpu' is the JAX package's; the port's "
            "on-device driver is 'cuda'")
    if driver == "cuda":
        from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
            CUDAVectorStore,
        )

        return CUDAVectorStore(cfg)
    if driver == "native":
        from copilot_for_consensus_tpu_torch.vectorstore.native import (
            NativeFlatVectorStore,
        )

        return NativeFlatVectorStore(cfg)
    if driver == "azure_ai_search":
        from copilot_for_consensus_tpu_torch.vectorstore import (
            azure_ai_search,
        )

        return azure_ai_search.AzureAISearchVectorStore(cfg)
    raise ValueError(f"unknown vector_store driver {driver!r}")


for _name in ("memory", "cuda", "native", "azure_ai_search"):
    register_driver("vector_store", _name, create_vector_store)
