"""JSON-schema validation enforced at every bus publish/subscribe and
document write.

Capability parity with the reference's ``copilot_schema_validation``
(``FileSchemaProvider`` + ``validate_json``, see SURVEY.md §2.1). Schemas
live as JSON files under ``copilot_for_consensus_tpu_torch/schemas/`` — the
contract layer is file-based so other processes/languages can share it.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Any, Mapping

import jsonschema

SCHEMA_ROOT = pathlib.Path(__file__).resolve().parent.parent / "schemas"


class SchemaValidationError(Exception):
    """Raised when a payload fails schema validation."""

    def __init__(self, schema_name: str, message: str):
        super().__init__(f"schema {schema_name!r}: {message}")
        self.schema_name = schema_name


class FileSchemaProvider:
    """Loads and caches JSON schemas from a directory tree.

    Schema names are paths relative to the root without the ``.schema.json``
    suffix, e.g. ``events/ArchiveIngested`` or ``documents/chunks``.
    """

    def __init__(self, root: pathlib.Path | str = SCHEMA_ROOT):
        self.root = pathlib.Path(root)
        self._cache: dict[str, dict[str, Any]] = {}
        self._validators: dict[str, jsonschema.Validator] = {}

    def get_schema(self, name: str) -> dict[str, Any]:
        if name not in self._cache:
            path = (self.root / f"{name}.schema.json").resolve()
            if not str(path).startswith(str(self.root.resolve()) + "/"):
                raise FileNotFoundError(f"schema name escapes root: {name!r}")
            if not path.exists():
                raise FileNotFoundError(f"no schema file for {name!r} at {path}")
            self._cache[name] = json.loads(path.read_text())
        return self._cache[name]

    def get_validator(self, name: str) -> jsonschema.Validator:
        if name not in self._validators:
            schema = self.get_schema(name)
            cls = jsonschema.validators.validator_for(schema)
            cls.check_schema(schema)
            self._validators[name] = cls(schema)
        return self._validators[name]

    def list_schemas(self, prefix: str = "") -> list[str]:
        base = self.root / prefix if prefix else self.root
        return sorted(
            str(p.relative_to(self.root))[: -len(".schema.json")]
            for p in base.rglob("*.schema.json")
        )


@functools.lru_cache(maxsize=1)
def default_schema_provider() -> FileSchemaProvider:
    return FileSchemaProvider()


def validate_json(payload: Mapping[str, Any], schema_name: str,
                  provider: FileSchemaProvider | None = None) -> None:
    """Validate ``payload`` against the named schema; raise on mismatch."""
    provider = provider or default_schema_provider()
    validator = provider.get_validator(schema_name)
    errors = sorted(validator.iter_errors(payload), key=lambda e: e.path)
    if errors:
        first = errors[0]
        where = "/".join(str(p) for p in first.path) or "<root>"
        raise SchemaValidationError(schema_name, f"{where}: {first.message}")


def validate_envelope(envelope: Mapping[str, Any],
                      provider: FileSchemaProvider | None = None) -> None:
    """Validate the envelope shape, then the event-specific data payload.

    ``event_type`` comes off the wire: it is checked against the typed event
    registry before being used to locate a schema, so unknown or malicious
    values ("../../x") raise SchemaValidationError, never touch paths.
    """
    from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES

    provider = provider or default_schema_provider()
    validate_json(envelope, "events/event-envelope", provider)
    etype = envelope["event_type"]
    if etype not in EVENT_TYPES:
        raise SchemaValidationError(
            "events/event-envelope", f"unknown event_type {etype!r}")
    validate_json(envelope["data"], f"events/{etype}", provider)
