"""CUDA summarizer: prompt building over the continuous-batching engine.

Port of the JAX package's ``summarization/tpu_summarizer.py``
(``TPUSummarizer`` → ``CUDASummarizer``): the same template,
``build_prompt``, ``shared_template_head``, ``cache_scope``,
``summarize`` and ``summarize_batch``, served by the port's
``GenerationEngine`` (a paged one with a prefix cache comes in through
``engine=``). Prompts longer than the engine's ``prompt_limit`` keep their
tail (there is no long-context engine here).
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    Tokenizer,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import (
    Summarizer,
    Summary,
    ThreadContext,
    citations_from_chunks,
)

DEFAULT_SYSTEM = (
    "You are a mailing-list analyst. Summarize the discussion thread "
    "faithfully, noting points of agreement and disagreement."
)
DEFAULT_TEMPLATE = (
    "{system}\n\n"
    "Thread: {subject} (id {thread_id})\n"
    "Participants: {participants}\n"
    "Messages: {message_count}\n\n"
    "Excerpts:\n{email_chunks}\n\n"
    "Summary:"
)


def build_prompt(thread: ThreadContext, template: str = DEFAULT_TEMPLATE,
                 system: str = DEFAULT_SYSTEM) -> str:
    excerpts = "\n---\n".join(
        (c.get("text") or "").strip() for c in thread.chunks)
    return template.format(
        system=system,
        subject=thread.subject,
        thread_id=thread.thread_id,
        participants=", ".join(thread.participants[:12]),
        message_count=thread.message_count,
        email_chunks=excerpts,
    )


#: per-thread template variables, in any order — everything BEFORE the
#: first of these in the template is byte-identical across threads
_THREAD_FIELDS = ("subject", "thread_id", "participants",
                  "message_count", "email_chunks")


def shared_template_head(template: str = DEFAULT_TEMPLATE,
                         system: str = DEFAULT_SYSTEM) -> str:
    """The rendered prompt span shared by EVERY thread's prompt: the
    template head up to the first per-thread placeholder, with the
    (deployment-constant) system prompt substituted — the span the
    summarizer marks prefix-cache-eligible under ``cache_scope="template"``."""
    cut = len(template)
    for fld in _THREAD_FIELDS:
        i = template.find("{" + fld + "}")
        if i >= 0:
            cut = min(cut, i)
    # only {system} may appear in the head; replace (not .format) so
    # stray braces in a custom template cannot raise
    return template[:cut].replace("{system}", system)


class CUDASummarizer(Summarizer):
    """Summaries from the port's engine. With no ``engine`` given it
    builds one for ``model`` with random weights from ``seed``, int8 by
    default (``quantize``), on ``device`` (None → the card).

    ``cache_scope`` is how much of each prompt the engine's prefix cache
    may publish (``GenerationEngine.submit``'s ``cache_eligible_tokens``):
    "full" — the whole prompt (a re-summarized thread re-sends a
    near-identical prompt); "template" — only the shared template head,
    for small pools where thread-unique context would evict it; "off" —
    nothing."""

    def __init__(self, model: str = "mistral-7b", *, engine=None,
                 tokenizer: Tokenizer | None = None,
                 max_new_tokens: int = 256,
                 template: str = DEFAULT_TEMPLATE,
                 system: str = DEFAULT_SYSTEM, num_slots: int = 4,
                 max_len: int = 4096, params: dict | None = None,
                 dtype: str | torch.dtype | None = None,
                 quantize: bool | str = "int8", seed: int = 0,
                 cache_scope: str = "full",
                 device: str | torch.device | None = None):
        self._model = model
        self.max_new_tokens = max_new_tokens
        self.template = template
        self.system = system
        if engine is None:
            cfg = decoder_config(model)
            engine = GenerationEngine(
                cfg, params, num_slots=num_slots,
                max_len=min(max_len, cfg.max_seq_len), quantize=quantize,
                seed=seed, dtype=dtype if dtype is not None
                else torch.bfloat16, device=resolve_device(device))
        self.engine = engine
        self.tokenizer: Tokenizer = tokenizer or ByteTokenizer(
            max(259, self.engine.cfg.vocab_size))
        if self.tokenizer.vocab_size > self.engine.cfg.vocab_size:
            raise ValueError("tokenizer vocab exceeds model vocab")
        if cache_scope not in ("full", "template", "off"):
            raise ValueError(f"unknown cache_scope {cache_scope!r}")
        self.cache_scope = cache_scope
        self._cache_eligible: int | None = None
        if cache_scope == "template":
            # BPE merges at the boundary may differ between the head alone
            # and a full prompt; one token shaved keeps the marked span
            # inside the shared bytes (the publish cap is block-aligned)
            head = shared_template_head(self.template, self.system)
            self._cache_eligible = max(
                0, len(self.tokenizer.encode(head, add_bos=True)) - 1)
        elif cache_scope == "off":
            self._cache_eligible = 0

    def summarize(self, thread: ThreadContext) -> Summary:
        return self.summarize_batch([thread])[0]

    def summarize_batch(self, threads: list[ThreadContext]) -> list[Summary]:
        """Continuous batching: all threads share the decode batch."""
        prompts = [
            self.tokenizer.encode(
                build_prompt(t, self.template, self.system), add_bos=True)
            for t in threads
        ]
        comps = self.engine.generate(
            prompts, self.max_new_tokens,
            cache_eligible_tokens=self._cache_eligible)
        return [
            Summary(
                thread_id=thread.thread_id,
                summary_text=self.tokenizer.decode(comp.tokens).strip(),
                citations=citations_from_chunks(thread.chunks),
                model=f"cuda:{self._model}",
                prompt_tokens=comp.prompt_len,
                completion_tokens=len(comp.tokens),
            )
            for thread, comp in zip(threads, comps)
        ]
