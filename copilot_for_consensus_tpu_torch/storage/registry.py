"""Collection → schema + primary-key registry, loaded from
``schemas/documents/collections.config.json`` (parity with the reference's
``copilot_storage/schema_registry.py``)."""

from __future__ import annotations

import functools
import json
from typing import Any

from copilot_for_consensus_tpu_torch.core.validation import SCHEMA_ROOT


@functools.lru_cache(maxsize=1)
def collection_registry() -> dict[str, dict[str, Any]]:
    path = SCHEMA_ROOT / "documents" / "collections.config.json"
    return json.loads(path.read_text())["collections"]


def primary_key(collection: str) -> str:
    reg = collection_registry()
    if collection in reg:
        return reg[collection]["primary_key"]
    return "_id"


def schema_name(collection: str) -> str | None:
    reg = collection_registry()
    if collection in reg:
        return reg[collection]["schema"]
    return None


KNOWN_COLLECTIONS = tuple(
    json.loads((SCHEMA_ROOT / "documents" / "collections.config.json").read_text())
    ["collections"]
)
