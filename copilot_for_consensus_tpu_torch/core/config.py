"""Schema-first runtime configuration.

Capability parity with the reference's ``copilot_config`` package
(``runtime_loader.py:384-400`` / ``adapter_factory.py:26`` — see SURVEY.md
§5 "Config / flag system"): JSON schemas are the single source of truth;
``get_config(service)`` resolves, in order,

1. schema defaults (``default`` keys, recursively),
2. an optional JSON config file (``COPILOT_CONFIG`` env var or argument),
3. environment overrides ``COPILOT_<SERVICE>__<SECTION>__<KEY>=value``
   (double-underscore nesting, values JSON-parsed when possible),
4. secret references (string values of the form ``secret://<name>``)
   resolved through a secret provider,

then fail-fast validates the merged result against the service schema and
returns an immutable attribute-access view.

Environment reads happen ONLY here — services never touch ``os.environ``
directly (the reference enforces this with a CI check,
``scripts/check_no_runtime_env_vars.py``; ours is
``tests/test_no_runtime_env_vars.py``).
"""

from __future__ import annotations

import copy
import json
import os
import pathlib
from typing import Any, Callable, Mapping

from copilot_for_consensus_tpu_torch.core.validation import (
    FileSchemaProvider,
    SchemaValidationError,
    default_schema_provider,
    validate_json,
)

SECRET_SCHEME = "secret://"


class ConfigError(Exception):
    pass


class FrozenConfig(Mapping):
    """Immutable nested mapping with attribute access: ``cfg.bus.driver``."""

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str) -> Any:
        try:
            value = self._data[name]
        except KeyError:
            raise AttributeError(name) from None
        return FrozenConfig(value) if isinstance(value, dict) else value

    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        return FrozenConfig(value) if isinstance(value, dict) else value

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def __setattr__(self, name, value):
        raise AttributeError("FrozenConfig is immutable")

    def get(self, key: str, default: Any = None) -> Any:
        value = self._data.get(key, default)
        return FrozenConfig(value) if isinstance(value, dict) else value

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self._data)

    def replace(self, **updates: Any) -> "FrozenConfig":
        """Return a copy with top-level keys replaced (deep-merging dicts).

        Used to stamp per-service identity onto shared adapter configs at
        boot, the way the reference uses ``dataclasses.replace``
        (``embedding/main.py:191-216``).
        """
        merged = copy.deepcopy(self._data)
        _deep_merge(merged, updates)
        return FrozenConfig(merged)

    def __repr__(self):
        return f"FrozenConfig({self._data!r})"


def _deep_merge(base: dict, overlay: Mapping) -> dict:
    for key, value in overlay.items():
        if (
            key in base
            and isinstance(base[key], dict)
            and isinstance(value, Mapping)
        ):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value) if isinstance(value, (dict, list)) else value
    return base


def _defaults_from_schema(schema: Mapping[str, Any]) -> Any:
    """Extract the default tree implied by a JSON schema."""
    if "default" in schema:
        return copy.deepcopy(schema["default"])
    if schema.get("type") == "object" and "properties" in schema:
        out = {}
        for key, sub in schema["properties"].items():
            val = _defaults_from_schema(sub)
            if val is not None:
                out[key] = val
        return out
    return None


def _parse_env_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def _apply_env_overrides(data: dict, service: str, env: Mapping[str, str]) -> None:
    prefix = f"COPILOT_{service.upper()}__"
    for key, raw in env.items():
        if not key.startswith(prefix):
            continue
        path = [p.lower() for p in key[len(prefix):].split("__") if p]
        if not path:
            continue
        node = data
        for part in path[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ConfigError(f"env override {key} collides with non-object")
        node[path[-1]] = _parse_env_value(raw)


def _resolve_secrets(node: Any, resolver: Callable[[str], str],
                     resolved: list[str]) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_secrets(v, resolver, resolved)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_secrets(v, resolver, resolved) for v in node]
    if isinstance(node, str) and node.startswith(SECRET_SCHEME):
        value = resolver(node[len(SECRET_SCHEME):])
        resolved.append(value)
        return value
    return node


def get_config(
    service: str,
    *,
    overrides: Mapping[str, Any] | None = None,
    config_path: str | pathlib.Path | None = None,
    env: Mapping[str, str] | None = None,
    secret_resolver: Callable[[str], str] | None = None,
    provider: FileSchemaProvider | None = None,
    validate: bool = True,
) -> FrozenConfig:
    """Load, merge, resolve and validate the typed config for ``service``."""
    env = os.environ if env is None else env
    provider = provider or default_schema_provider()
    schema = provider.get_schema(f"configs/services/{service}")

    data: dict[str, Any] = _defaults_from_schema(schema) or {}

    path = config_path or env.get("COPILOT_CONFIG")
    if path:
        path = pathlib.Path(path)
        if not path.exists():
            raise ConfigError(f"config file not found: {path}")
        file_data = json.loads(path.read_text())
        # A combined multi-service file declares itself with a "services"
        # wrapper: {"services": {"embedding": {...}, "parsing": {...}}}.
        # Anything else is a per-service file used as-is (guessing from key
        # names would misfire on services whose schema has a section named
        # after the service, e.g. auth.auth).
        if "services" in file_data and isinstance(file_data["services"], Mapping):
            file_data = file_data["services"].get(service, {})
        _deep_merge(data, file_data)

    if overrides:
        _deep_merge(data, overrides)

    _apply_env_overrides(data, service, env)

    if secret_resolver is None:
        from copilot_for_consensus_tpu_torch.security.secrets import default_secret_resolver

        secret_resolver = default_secret_resolver(env)
    resolved_secrets: list[str] = []
    data = _resolve_secrets(data, secret_resolver, resolved_secrets)

    if not data.get("service_name"):
        data["service_name"] = service
    if validate:
        try:
            validate_json(data, f"configs/services/{service}", provider)
        except SchemaValidationError as exc:
            # Never leak resolved secret values through validation errors.
            message = str(exc)
            for value in resolved_secrets:
                if value:
                    message = message.replace(value, "***")
            raise SchemaValidationError(
                f"configs/services/{service}", message) from None
    return FrozenConfig(data)
