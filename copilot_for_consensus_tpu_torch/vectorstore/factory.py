"""Vector store driver registration + create_vector_store (port of the
JAX package's ``vectorstore/factory.py``).

Drivers: ``memory`` and ``azure_ai_search``. The JAX package's ``tpu``
(on-device flat and IVF search) and ``native`` (its C++ flat index)
drivers are refused until the port's vector store lands (ROADMAP Queue 1
item 3).
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
    if driver in ("tpu", "native"):
        raise NotImplementedError(
            f"vector_store driver {driver!r} is not ported yet: ROADMAP "
            f"Queue 1 item 3 (vectorstore/tpu.py, vectorstore/ivf.py)")
    if driver == "azure_ai_search":
        from copilot_for_consensus_tpu_torch.vectorstore import (
            azure_ai_search,
        )

        return azure_ai_search.AzureAISearchVectorStore(cfg)
    raise ValueError(f"unknown vector_store driver {driver!r}")


for _name in ("memory", "azure_ai_search"):
    register_driver("vector_store", _name, create_vector_store)
