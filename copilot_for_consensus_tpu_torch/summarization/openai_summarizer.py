"""OpenAI-compatible chat-completions summarizer driver.

The reference speaks this API twice — ``OpenAISummarizer``
(``copilot_summarization/openai_summarizer.py:23,46``, which also serves
the azure_openai_gpt driver) and, shape-wise, its Ollama/llama.cpp local
backends. One driver here covers all of them: any endpoint implementing
``POST {base_url}/chat/completions`` (OpenAI, Azure OpenAI, vLLM,
Ollama's compat mode, llama.cpp's server) plugs into the pipeline as an
alternative to the first-party TPU engine. stdlib-HTTP only; the
container is zero-egress, so tests drive it against an in-process mock
server and real use needs network access.

Citations still come from the retrieved chunks, never parsed out of the
model's text — the reference's deliberate design
(``summarization/app/service.py:291-307``).
"""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.openai_compat import openai_post
from copilot_for_consensus_tpu_torch.summarization.base import (
    RateLimitError,
    SummarizationError,
    Summarizer,
    Summary,
    ThreadContext,
    citations_from_chunks,
)
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    DEFAULT_SYSTEM,
    DEFAULT_TEMPLATE,
    build_prompt,
)


class OpenAISummarizer(Summarizer):
    """Chat-completions client. ``base_url`` up to the API root (e.g.
    ``https://api.openai.com/v1`` or ``http://ollama:11434/v1``);
    ``api_version`` switches to Azure OpenAI conventions (api-key header
    + query parameter)."""

    def __init__(self, base_url: str, *, api_key: str = "",
                 model: str = "gpt-4o-mini", temperature: float = 0.2,
                 max_tokens: int = 512, timeout_s: float = 60.0,
                 api_version: str = "",
                 template: str = DEFAULT_TEMPLATE,
                 system: str = DEFAULT_SYSTEM):
        if not base_url:
            raise ValueError("openai summarizer needs a base_url")
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout_s = timeout_s
        self.api_version = api_version
        self.template = template
        self.system = system

    def _request(self, body: dict[str, Any]) -> dict[str, Any]:
        return openai_post(
            self.base_url, "/chat/completions", body,
            api_key=self.api_key, api_version=self.api_version,
            timeout_s=self.timeout_s, error_cls=SummarizationError,
            rate_limit_cls=RateLimitError)

    def summarize(self, thread: ThreadContext) -> Summary:
        out = self._request({
            "model": self.model,
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
            "messages": [
                {"role": "system", "content": self.system},
                {"role": "user",
                 "content": build_prompt(thread, self.template, "")},
            ],
        })
        try:
            text = out["choices"][0]["message"]["content"]
        except (KeyError, IndexError, TypeError) as exc:
            raise SummarizationError(
                f"malformed completion response: {out!r:.300}") from exc
        usage = out.get("usage") or {}
        return Summary(
            thread_id=thread.thread_id,
            summary_text=(text or "").strip(),
            citations=citations_from_chunks(thread.chunks),
            model=out.get("model", self.model),
            prompt_tokens=int(usage.get("prompt_tokens", 0)),
            completion_tokens=int(usage.get("completion_tokens", 0)),
        )
