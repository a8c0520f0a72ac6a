"""CUDA summarizer: prompt building over the continuous-batching engine.

Port of the JAX package's ``summarization/tpu_summarizer.py``
(``TPUSummarizer`` → ``CUDASummarizer``): the same template,
``build_prompt``, ``summarize`` and ``summarize_batch``, served by the
port's ``GenerationEngine``. Prompts longer than the engine's
``prompt_limit`` keep their tail (there is no long-context engine here).
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


class CUDASummarizer(Summarizer):
    """Summaries from the port's engine. With no ``engine`` given it
    builds one for ``model`` with random weights from ``seed``, int8 by
    default (``quantize``), on ``device`` (None → the card)."""

    def __init__(self, model: str = "mistral-7b", *, engine=None,
                 tokenizer: Tokenizer | None = None,
                 max_new_tokens: int = 256,
                 template: str = DEFAULT_TEMPLATE,
                 system: str = DEFAULT_SYSTEM, num_slots: int = 4,
                 max_len: int = 4096, params: dict | None = None,
                 dtype: str | torch.dtype | None = None,
                 quantize: bool | str = "int8", seed: int = 0,
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

    def summarize(self, thread: ThreadContext) -> Summary:
        return self.summarize_batch([thread])[0]

    def summarize_batch(self, threads: list[ThreadContext]) -> list[Summary]:
        """Continuous batching: all threads share the decode batch."""
        prompts = [
            self.tokenizer.encode(
                build_prompt(t, self.template, self.system), add_bos=True)
            for t in threads
        ]
        comps = self.engine.generate(prompts, self.max_new_tokens)
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
