"""Document store abstraction over the 6 pipeline collections.

Capability parity with the reference's ``copilot_storage`` package
(ABC ``document_store.py:40``; Mongo/Cosmos/InMemory drivers; validating
wrapper; collection→schema registry — SURVEY.md §2.1). Drivers here:

* ``memory`` — dict-backed, for tests and the single-process runner;
* ``sqlite`` — durable single-host store on stdlib sqlite3 (WAL mode), the
  default persistent driver (the environment bans new services; a Mongo
  driver slot exists for when pymongo is present).

The store is the pipeline's durable state machine (SURVEY.md §5
"Checkpoint / resume"): per-document status flags + content-addressed ids
make every stage resumable and idempotent.
"""

from copilot_for_consensus_tpu_torch.storage.base import (
    DocumentStore,
    DuplicateKeyError,
    StorageError,
    matches_filter,
)
from copilot_for_consensus_tpu_torch.storage.memory import InMemoryDocumentStore
from copilot_for_consensus_tpu_torch.storage.sqlite import SQLiteDocumentStore
from copilot_for_consensus_tpu_torch.storage.validating import ValidatingDocumentStore
from copilot_for_consensus_tpu_torch.storage.factory import create_document_store

__all__ = [
    "DocumentStore",
    "DuplicateKeyError",
    "StorageError",
    "matches_filter",
    "InMemoryDocumentStore",
    "SQLiteDocumentStore",
    "ValidatingDocumentStore",
    "create_document_store",
]
