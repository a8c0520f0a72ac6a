"""Vector store abstraction: embedding storage + top-k similarity search.

Capability parity with the reference's ``copilot_vectorstore`` package
(ABC ``interface.py:28-126``; Qdrant/FAISS/InMemory/AzureAISearch drivers —
SURVEY.md §2.1). Drivers here:

* ``memory`` — numpy exact search (tests, small corpora);
* ``tpu``    — on-device ANN: HBM-resident vectors, sharded matmul top-k
  under jit (``ann/``), the north-star replacement for Qdrant/FAISS;
* ``native`` — C++ flat index via ctypes for host-side search without a
  device (fills the FAISS role).

All drivers upsert on add (idempotent re-embedding, reference
``interface.py:40-42``).
"""

from copilot_for_consensus_tpu_torch.vectorstore.base import (
    QueryResult,
    VectorStore,
    VectorStoreError,
)
from copilot_for_consensus_tpu_torch.vectorstore.memory import InMemoryVectorStore
from copilot_for_consensus_tpu_torch.vectorstore.factory import create_vector_store

__all__ = [
    "QueryResult",
    "VectorStore",
    "VectorStoreError",
    "InMemoryVectorStore",
    "create_vector_store",
]
