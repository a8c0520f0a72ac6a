"""CUDA summarizer: prompt building over the continuous-batching engine.

Port of the JAX package's ``summarization/tpu_summarizer.py``
(``TPUSummarizer`` → ``CUDASummarizer``): the same template,
``build_prompt``, ``shared_template_head``, ``cache_scope``,
``summarize``, ``summarize_batch`` and the async front end
(``summarize_async``, ``drain``, ``close``: the engine behind an
``AsyncEngineRunner`` and its supervisor), the default scheduling identity
(``tenant``, ``priority``), the per-request ``deadline_s``, the request
``journal`` and the ``kv_dtype``, served by the port's
``GenerationEngine`` (a paged one with a prefix cache comes in through
``engine=``). Prompts longer than the engine's ``prompt_limit`` keep their
tail (there is no long-context engine here).
"""

from __future__ import annotations

import threading

import torch

from copilot_for_consensus_tpu_torch.checkpoint.native import (
    load_tokenizer,
)
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
    builds one on ``device`` (None → the card): from ``checkpoint`` (a
    native or HF directory, whose metadata gives the quantize mode and
    whose ``tokenizer.json`` the tokenizer, unless ``tokenizer`` is
    given), else for ``model`` with random weights from ``seed``, int8 by
    default (``quantize``).

    ``cache_scope`` is how much of each prompt the engine's prefix cache
    may publish (``GenerationEngine.submit``'s ``cache_eligible_tokens``):
    "full" — the whole prompt (a re-summarized thread re-sends a
    near-identical prompt); "template" — only the shared template head,
    for small pools where thread-unique context would evict it; "off" —
    nothing.

    ``tenant`` and ``priority`` are the default scheduling identity of this
    summarizer's requests (a call's own override them); ``deadline_s`` is
    each request's wall-clock budget through the runner (expired work is
    dropped, and a drop with no tokens raises ``EngineFailed``);
    ``journal`` (a path, a ``{"path", "checkpoint_every"}`` dict or an
    ``EngineJournal``) and ``kv_dtype`` go to the engine it builds."""

    def __init__(self, model: str = "mistral-7b", *, engine=None,
                 tokenizer: Tokenizer | None = None,
                 max_new_tokens: int = 256,
                 template: str = DEFAULT_TEMPLATE,
                 system: str = DEFAULT_SYSTEM, num_slots: int = 4,
                 max_len: int = 4096, params: dict | None = None,
                 checkpoint: str | None = None,
                 dtype: str | torch.dtype | None = None,
                 quantize: bool | str = "int8", seed: int = 0,
                 cache_scope: str = "full", supervisor=None,
                 tenant: str = "", priority: str = "",
                 deadline_s: float | None = None, journal=None,
                 kv_dtype: str | torch.dtype | None = None,
                 device: str | torch.device | None = None):
        self._model = model
        #: the default scheduling identity; a call's own overrides it
        self.tenant = tenant
        self.priority = priority
        #: each request's wall-clock budget (None: no deadline)
        self.deadline_s = deadline_s
        #: resilience (engine/supervisor.py): True / a SupervisorConfig
        #: wires the watchdog, containment, request replay and breakers
        #: into the runner ``summarize_async`` builds; None (the JAX
        #: package's default) leaves the runner's fail-all containment
        self.supervisor = supervisor
        #: obs reporter for engine dispatch failures, set by the owning
        #: service; the runner reports through it
        self.error_reporter = None
        self._runner = None
        # two threads submitting the first requests at once must not each
        # start a runner: two dispatchers would drive one engine
        self._runner_lock = threading.Lock()
        self.max_new_tokens = max_new_tokens
        self.template = template
        self.system = system
        if engine is None and checkpoint is not None:
            if tokenizer is None:
                # before the weights load: a byte-level fallback against
                # a BPE-trained model yields garbage, so refuse loudly
                tokenizer = load_tokenizer(checkpoint)
                if tokenizer is None:
                    raise ValueError(
                        f"checkpoint {checkpoint} has no "
                        "tokenizer.json; pass tokenizer= explicitly")
            # real weights: the quantize mode is the checkpoint's own
            engine = GenerationEngine.from_checkpoint(
                checkpoint, num_slots=num_slots, max_len=max_len,
                seed=seed, kv_dtype=kv_dtype, journal=journal,
                dtype=dtype if dtype is not None else torch.bfloat16,
                device=device)
            self._model = f"checkpoint:{checkpoint}"
        elif engine is None:
            cfg = decoder_config(model)
            engine = GenerationEngine(
                cfg, params, num_slots=num_slots,
                max_len=min(max_len, cfg.max_seq_len), quantize=quantize,
                seed=seed, kv_dtype=kv_dtype, journal=journal,
                dtype=dtype if dtype is not None else torch.bfloat16,
                device=resolve_device(device))
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

    def _summary(self, thread: ThreadContext, comp) -> Summary:
        return Summary(
            thread_id=thread.thread_id,
            summary_text=self.tokenizer.decode(comp.tokens).strip(),
            citations=citations_from_chunks(thread.chunks),
            model=f"cuda:{self._model}",
            prompt_tokens=comp.prompt_len,
            completion_tokens=len(comp.tokens),
        )

    def _prompt(self, thread: ThreadContext) -> list[int]:
        return self.tokenizer.encode(
            build_prompt(thread, self.template, self.system), add_bos=True)

    def _engine_generate(self, prompts: list[list[int]]) -> list:
        """All generation funnels through here so that the engine keeps a
        single owner: once ``summarize_async`` has started the runner's
        dispatcher thread, it owns the engine (and its CUDA graphs), and
        a synchronous caller goes through it rather than racing it."""
        if self._runner is None:
            return self.engine.generate(
                prompts, self.max_new_tokens,
                cache_eligible_tokens=self._cache_eligible)
        handles = [self._runner.submit(
            p, self.max_new_tokens,
            cache_eligible_tokens=self._cache_eligible, tenant=self.tenant,
            priority=self.priority, deadline_s=self.deadline_s)
            for p in prompts]
        return [self._checked(h.result(timeout=600.0)) for h in handles]

    @staticmethod
    def _checked(comp):
        """A deadline drop with no tokens is a failure, not an empty
        summary the service would store and publish: it raises the
        structured ``EngineFailed`` that the bus retry path handles."""
        if comp.finish_reason == "deadline" and not comp.tokens:
            from copilot_for_consensus_tpu_torch.engine.supervisor import (
                EngineFailed,
            )
            raise EngineFailed(
                f"request {comp.request_id} dropped at its deadline "
                f"before any tokens were generated",
                request_id=comp.request_id, reason="deadline-expired")
        return comp

    def summarize_batch(self, threads: list[ThreadContext]) -> list[Summary]:
        """Continuous batching: all threads share the decode batch."""
        comps = self._engine_generate([self._prompt(t) for t in threads])
        return [self._summary(t, c) for t, c in zip(threads, comps)]

    def summarize_async(self, thread: ThreadContext, *,
                        correlation_id: str = "", tenant: str = "",
                        priority: str = ""):
        """Submit one thread into the continuous batch without waiting:
        returns a callable ``wait(timeout=600.0)`` that blocks for the
        Summary. Many submissions in flight share the decode batch —
        what fills the engine's slots when a service receives work one
        event at a time. The first call starts an ``AsyncEngineRunner``
        (with the summarizer's ``supervisor``), whose dispatcher thread
        owns the engine from then on. ``correlation_id`` (the pipeline
        event id) tags the request, so its telemetry span, an engine error
        report or a replay names it. ``tenant`` and ``priority`` (falling
        back to the summarizer's defaults) are the request's scheduling
        identity, journaled with it; the summarizer's ``deadline_s`` is
        its budget.

        Left out against the JAX package's ``TPUSummarizer``: the
        long-context route (prompts over ``prompt_limit`` keep their
        tail)."""
        from copilot_for_consensus_tpu_torch.engine.async_runner import (
            AsyncEngineRunner,
        )

        fi = getattr(self.engine, "faults", None)
        if fi is not None:
            # tokenization is a host boundary of the serving path too
            fi.check("tokenize")
        prompt = self._prompt(thread)
        with self._runner_lock:
            if self._runner is None:
                self._runner = AsyncEngineRunner(
                    self.engine, error_reporter=self.error_reporter,
                    supervisor=self.supervisor).start()
            runner = self._runner
        handle = runner.submit(
            prompt, self.max_new_tokens,
            cache_eligible_tokens=self._cache_eligible,
            correlation_id=correlation_id, tenant=tenant or self.tenant,
            priority=priority or self.priority, deadline_s=self.deadline_s)

        def wait(timeout: float | None = 600.0) -> Summary:
            return self._summary(thread,
                                 self._checked(handle.result(timeout)))

        return wait

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Graceful drain: wait up to ``deadline_s`` for the runner to
        finish its queued and active work, then stop it. True when the
        engine fully drained (and when no runner was started)."""
        with self._runner_lock:
            runner, self._runner = self._runner, None
        if runner is None:
            return True
        drained = runner.drain(deadline_s)
        runner.stop()
        return drained

    def close(self) -> None:
        """Stop the runner, if one was started; outstanding handles fail
        with "runner stopped"."""
        with self._runner_lock:
            runner, self._runner = self._runner, None
        if runner is not None:
            runner.stop()
