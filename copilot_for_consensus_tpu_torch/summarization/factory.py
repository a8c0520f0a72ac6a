"""LLM-backend driver registry (port of the JAX package's
``summarization/factory.py``).

Drivers: ``mock``, ``cuda`` (the port's ``CUDASummarizer``, the
counterpart of the JAX package's ``tpu`` driver; ``device`` from the
config, None meaning the card), ``openai`` and ``azure_openai``. The
``tpu`` driver is refused with a pointer to ``cuda``. The ``cuda`` driver
takes the ``tpu`` driver's options as it does (``supervisor``,
``deadline_s``, ``journal`` or ``journal_path``, ``kv_dtype``); an option
the port does not serve yet raises ``NotImplementedError`` naming the
ROADMAP item that brings it; none is dropped silently.
"""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.core.openai_compat import (
    azure_default_api_version,
)
from copilot_for_consensus_tpu_torch.summarization.base import (
    MockSummarizer,
    Summarizer,
)

#: options of the JAX package's ``tpu`` driver the port does not serve
#: yet → the ROADMAP Queue 1 item that brings each
_NOT_YET = {
    "long_context": "item 6 (engine/longctx.py, the long-context route)",
    "profile_dir": "item 7 (obs/profile.py on torch.profiler)",
}


def _cfg_get(config: Any, key: str, default=None):
    if config is None:
        return default
    if isinstance(config, dict):
        return config.get(key, default)
    return getattr(config, key, default)


def _refuse_unserved(config: Any) -> None:
    for key, item in _NOT_YET.items():
        if _cfg_get(config, key):
            raise NotImplementedError(
                f"llm_backend option {key!r} is not served by the port's "
                f"cuda driver yet: ROADMAP Queue 1 {item}")


def create_summarizer(config: Any = None, **kwargs: Any) -> Summarizer:
    driver = _cfg_get(config, "driver", "mock")
    if driver == "mock":
        return MockSummarizer(
            max_sentences=int(_cfg_get(config, "max_sentences", 3)))
    if driver == "tpu":
        raise ValueError(
            "llm_backend driver 'tpu' is the JAX package's; the port's "
            "engine-backed driver is 'cuda'")
    if driver == "cuda":
        _refuse_unserved(config)
        from copilot_for_consensus_tpu_torch.summarization.summarizer import (
            CUDASummarizer,
        )
        return CUDASummarizer(
            model=_cfg_get(config, "model", "mistral-7b"),
            max_new_tokens=int(_cfg_get(config, "max_new_tokens", 256)),
            num_slots=int(_cfg_get(config, "num_slots", 4)),
            max_len=int(_cfg_get(config, "max_len", 4096)),
            checkpoint=_cfg_get(config, "checkpoint") or None,
            kv_dtype=_cfg_get(config, "kv_dtype") or None,
            quantize=_cfg_get(config, "quantize", "int8"),
            # resilience (engine/supervisor.py): supervisor=true wires
            # watchdog + request replay + degraded-mode breakers into
            # the engine's dispatcher; deadline_s drops expired work
            supervisor=_cfg_get(config, "supervisor", None),
            deadline_s=_cfg_get(config, "deadline_s", None),
            # the request journal (engine/journal.py): a config dict
            # {"path": ..., "checkpoint_every": ...} or the "journal_path"
            # string; either way the engine warm-restarts from it
            journal=(_cfg_get(config, "journal", None)
                     or _cfg_get(config, "journal_path", None)),
            device=_cfg_get(config, "device"),
            **kwargs,
        )
    if driver in ("openai", "azure_openai"):
        # One client covers the reference's llm_openai AND
        # llm_azure_openai_gpt drivers (openai_summarizer.py:23), plus
        # any OpenAI-compatible server (vLLM/Ollama/llama.cpp).
        from copilot_for_consensus_tpu_torch.summarization.openai_summarizer \
            import OpenAISummarizer

        return OpenAISummarizer(
            base_url=_cfg_get(config, "base_url", ""),
            api_key=_cfg_get(config, "api_key", "") or "",
            model=_cfg_get(config, "model", "gpt-4o-mini"),
            temperature=float(_cfg_get(config, "temperature", 0.2)),
            max_tokens=int(_cfg_get(config, "max_tokens", 512)),
            api_version=azure_default_api_version(
                driver, _cfg_get(config, "api_version", "")),
        )
    raise ValueError(f"unknown llm_backend driver {driver!r}")


register_driver("llm_backend", "mock", create_summarizer)
register_driver("llm_backend", "cuda", create_summarizer)
register_driver("llm_backend", "openai", create_summarizer)
register_driver("llm_backend", "azure_openai", create_summarizer)
