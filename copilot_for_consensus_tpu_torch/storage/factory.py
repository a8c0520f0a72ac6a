"""Document store driver registration + create_document_store."""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.storage.memory import InMemoryDocumentStore
from copilot_for_consensus_tpu_torch.storage.sqlite import SQLiteDocumentStore
from copilot_for_consensus_tpu_torch.storage.validating import ValidatingDocumentStore


def create_document_store(config: Any = None, validate: bool = True):
    cfg = dict(config or {})
    driver = cfg.get("driver", "memory")
    if driver == "memory":
        store = InMemoryDocumentStore(cfg)
    elif driver == "sqlite":
        store = SQLiteDocumentStore(cfg)
    elif driver == "azure_cosmos":
        from copilot_for_consensus_tpu_torch.storage.azure_cosmos import (
            AzureCosmosDocumentStore,
        )

        store = AzureCosmosDocumentStore(
            account=cfg.get("account", ""),
            master_key=cfg.get("master_key", ""),
            database=cfg.get("database", "copilot"),
            endpoint=cfg.get("endpoint", "") or "")
    else:
        raise ValueError(f"unknown document_store driver {driver!r}")
    return ValidatingDocumentStore(store) if validate else store


for _name in ("memory", "sqlite", "azure_cosmos"):
    register_driver("document_store", _name, create_document_store)
