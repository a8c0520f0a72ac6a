"""Generic adapter factory: config-driven driver dispatch.

Capability parity with the reference's
``copilot_config/adapter_factory.py:26`` — every pluggable subsystem
(message bus, document store, vector store, embedding backend, llm backend,
metrics, logger, …) registers named drivers here, and ``create_adapter``
instantiates the right one from ``config.driver``.

Drivers are registered as lazy import strings so importing the factory pulls
in no heavy dependencies; the subsystem module is only imported when its
driver is actually constructed.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

from copilot_for_consensus_tpu_torch.core.config import FrozenConfig


class UnknownDriverError(Exception):
    pass


# kind -> driver name -> "module.path:ClassName" or callable
_REGISTRY: dict[str, dict[str, Any]] = {}
_LOADED_KINDS: set[str] = set()

# kind -> module that registers its drivers on import
_KIND_MODULES = {
    "message_bus": "copilot_for_consensus_tpu_torch.bus.factory",
    "document_store": "copilot_for_consensus_tpu_torch.storage.factory",
    "vector_store": "copilot_for_consensus_tpu_torch.vectorstore.factory",
    "embedding_backend": "copilot_for_consensus_tpu_torch.embedding.factory",
    "llm_backend": "copilot_for_consensus_tpu_torch.summarization.factory",
    "chunker": "copilot_for_consensus_tpu_torch.text.factory",
    "metrics": "copilot_for_consensus_tpu_torch.obs.factory",
    "logger": "copilot_for_consensus_tpu_torch.obs.factory",
    "error_reporter": "copilot_for_consensus_tpu_torch.obs.factory",
    "archive_fetcher": "copilot_for_consensus_tpu_torch.fetch.factory",
    "archive_store": "copilot_for_consensus_tpu_torch.archive.factory",
    "consensus_detector": "copilot_for_consensus_tpu_torch.consensus.factory",
    "draft_diff_provider": "copilot_for_consensus_tpu_torch.draftdiff.factory",
    "secret_provider": "copilot_for_consensus_tpu_torch.security.factory",
    "jwt_signer": "copilot_for_consensus_tpu_torch.security.factory",
    "oidc_provider": "copilot_for_consensus_tpu_torch.security.factory",
    "event_retry": "copilot_for_consensus_tpu_torch.core.retry",
}


def register_driver(kind: str, name: str, target: str | Callable[..., Any]) -> None:
    _REGISTRY.setdefault(kind, {})[name] = target


def available_drivers(kind: str) -> list[str]:
    _ensure_kind_loaded(kind)
    return sorted(_REGISTRY.get(kind, {}))


def _ensure_kind_loaded(kind: str) -> None:
    if kind in _LOADED_KINDS:
        return
    _LOADED_KINDS.add(kind)
    module = _KIND_MODULES.get(kind)
    if module is None:
        return
    try:
        importlib.import_module(module)
    except ModuleNotFoundError as exc:
        # Only swallow "the registering module itself doesn't exist (yet)" —
        # a missing dependency inside it is a real error and must surface.
        if exc.name != module:
            raise


def _resolve(target: str | Callable[..., Any]) -> Callable[..., Any]:
    if callable(target):
        return target
    module_path, _, attr = target.partition(":")
    module = importlib.import_module(module_path)
    return getattr(module, attr)


def create_adapter(kind: str, config: Any, **kwargs: Any) -> Any:
    """Instantiate the driver named by ``config.driver`` for ``kind``.

    ``config`` may be a FrozenConfig, a plain mapping, or None (meaning
    ``{"driver": "noop"}``). Extra kwargs are forwarded to the constructor.
    """
    if config is None:
        config = {"driver": "noop"}
    if not isinstance(config, FrozenConfig):
        config = FrozenConfig(dict(config))
    driver = config.get("driver")
    if not driver:
        raise UnknownDriverError(f"{kind}: config has no 'driver' key")
    _ensure_kind_loaded(kind)
    table = _REGISTRY.get(kind, {})
    if driver not in table:
        raise UnknownDriverError(
            f"{kind}: unknown driver {driver!r}; available: {sorted(table)}"
        )
    ctor = _resolve(table[driver])
    return ctor(config, **kwargs)
