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
``engine=``). With ``long_context=True`` (or a ``long_engine``) a prompt
over the engine's ``prompt_limit`` goes whole to the port's
``LongContextEngine`` (``engine/longctx.py``), built over the short
engine's own tensors: one weight residency on the card. Without one such
a prompt keeps its tail. ``profile_dir`` reaches both engines, which then
write a torch.profiler trace of each ``generate``.
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
    ``EngineJournal``), ``kv_dtype`` and ``profile_dir`` go to the engine
    it builds.

    ``long_context=True`` builds a ``LongContextEngine`` over the engine's
    params (the same tensors), its EOS ids, ``max_new_tokens`` and
    ``profile_dir``; ``long_engine`` hands one in. Every prompt over the
    engine's ``prompt_limit`` then goes to it whole, in ``summarize``,
    ``summarize_batch`` and ``summarize_async``.

    ``mesh`` (``parallel.build_mesh``) builds the engine over a dp×tp mesh;
    above one rank every rank makes the same calls with the same threads
    (``summarize`` and ``summarize_batch``; lockstep) and gets the same
    summaries. The options reach the mesh engine as they reach one
    device (the journal lives on rank 0; an ``engine=`` built over the
    mesh brings speculation, the scheduler and the paged prefix cache),
    while the long route (item 6c.2) raises. To serve work one event at a
    time, rank 0 calls ``summarize_async`` (and ``drain``, ``close``)
    and every other rank calls :meth:`follow`, which serves rank 0's
    traffic until rank 0 stops (``engine/mesh_runner.py``); once rank 0's
    runner runs, its ``summarize_batch`` goes through it too."""

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
                 long_engine=None, long_context: bool = False,
                 profile_dir: str | None = None,
                 device: str | torch.device | None = None, mesh=None):
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
        #: on rank 0 of a mesh: keep the runner's operation log and its
        #: completions (``self._runner.oplog``)
        self.keep_mesh_log = False
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
                profile_dir=profile_dir,
                dtype=dtype if dtype is not None else torch.bfloat16,
                device=device, mesh=mesh)
            self._model = f"checkpoint:{checkpoint}"
        elif engine is None:
            cfg = decoder_config(model)
            engine = GenerationEngine(
                cfg, params, num_slots=num_slots,
                max_len=min(max_len, cfg.max_seq_len), quantize=quantize,
                seed=seed, kv_dtype=kv_dtype, journal=journal,
                profile_dir=profile_dir,
                dtype=dtype if dtype is not None else torch.bfloat16,
                device=resolve_device(device, mesh), mesh=mesh)
        self.engine = engine
        #: the engine's mesh: above one rank, every rank calls this
        #: summarizer alike (lockstep), and what cannot run so raises
        self.mesh = getattr(engine, "mesh", None)
        if self._multi_rank and (long_engine is not None or long_context):
            raise NotImplementedError(
                "CUDASummarizer(long_context=...) on a mesh of several "
                "ranks: the long route's sequence parallelism is ROADMAP "
                "Queue 1 item 6c.2 (sp)")
        if long_engine is None and long_context:
            from copilot_for_consensus_tpu_torch.engine.longctx import (
                LongContextEngine,
            )
            # the short engine's tensors themselves: one weight residency
            long_engine = LongContextEngine(
                engine.cfg, engine.params, eos_id=sorted(engine._eos_set),
                max_new_tokens=max_new_tokens, profile_dir=profile_dir,
                dtype=engine.dtype, device=engine.device)
        #: whole-thread prompts over the short engine's window go here
        #: instead of being tail-truncated
        self.long_engine = long_engine
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

    @property
    def _multi_rank(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def _short_limit(self) -> int:
        return self.engine.prompt_limit

    def _is_long(self, prompt: list[int]) -> bool:
        return self.long_engine is not None and \
            len(prompt) > self._short_limit

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
        """Continuous batching: all threads share the decode batch; a
        prompt over the batch engine's window runs on the long-context
        engine, when there is one."""
        prompts = [self._prompt(t) for t in threads]
        comps: list = [None] * len(threads)
        short = [i for i, p in enumerate(prompts) if not self._is_long(p)]
        for i, p in enumerate(prompts):
            if self._is_long(p):
                comps[i] = self.long_engine.generate(
                    p, max_new_tokens=self.max_new_tokens)
        if short:
            for i, c in zip(short, self._engine_generate(
                    [prompts[i] for i in short])):
                comps[i] = c
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

        A prompt over the batch engine's window, with a long-context
        engine present, runs synchronously on the caller's thread, on the
        long engine (its own CUDA stream, the short engine's tensors), and
        the returned callable is ready at once.

        On a mesh of several ranks this is rank 0's entry: its runner
        publishes every engine call to the other ranks, which serve it in
        :meth:`follow`; on any other rank it raises ``ValueError``."""
        if self._multi_rank and not self.mesh.is_first:
            raise ValueError(
                f"CUDASummarizer.summarize_async serves on rank 0 of the "
                f"mesh of {self.mesh.size} ranks; this rank serves rank 0's "
                f"traffic through CUDASummarizer.follow()")

        fi = getattr(self.engine, "faults", None)
        if fi is not None:
            # tokenization is a host boundary of the serving path too
            fi.check("tokenize")
        prompt = self._prompt(thread)
        if self._is_long(prompt):
            # the long engine owns its own device work: it never drives
            # self.engine, whose single owner is the runner once one runs
            summary = self._summary(thread, self.long_engine.generate(
                prompt, max_new_tokens=self.max_new_tokens,
                correlation_id=correlation_id))
            return lambda timeout=600.0: summary
        with self._runner_lock:
            if self._runner is None:
                self._runner = self._new_runner().start()
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

    def _new_runner(self):
        """The runner ``summarize_async`` starts: rank 0's
        ``MeshEngineRunner`` on a mesh of several ranks, else the
        ``AsyncEngineRunner``."""
        if self._multi_rank:
            from copilot_for_consensus_tpu_torch.engine.mesh_runner import (
                MeshEngineRunner,
            )
            return MeshEngineRunner(
                self.engine, error_reporter=self.error_reporter,
                supervisor=self.supervisor, keep_log=self.keep_mesh_log)
        from copilot_for_consensus_tpu_torch.engine.async_runner import (
            AsyncEngineRunner,
        )
        return AsyncEngineRunner(
            self.engine, error_reporter=self.error_reporter,
            supervisor=self.supervisor)

    def follow(self, *, keep: bool = False) -> dict:
        """The entry of every rank but 0 of a mesh of several ranks: serve
        rank 0's ``summarize_async`` traffic (its operation log) on this
        rank's engine, blocking until rank 0's ``drain`` or ``close``
        stops its runner. Returns this rank's counts
        (``engine.mesh_runner.follow``); ``closed`` is True once rank 0
        closed, so a rank that serves several of rank 0's sessions calls
        this until then."""
        if not self._multi_rank:
            raise ValueError("CUDASummarizer.follow() serves a mesh of "
                             "several ranks; one rank has no leader")
        from copilot_for_consensus_tpu_torch.engine.mesh_runner import (
            follow,
        )
        return follow(self.engine, keep=keep)

    def _end(self, drain_s: float | None) -> bool:
        """Stop the runner (after draining it for ``drain_s``, when
        given); on rank 0 of a mesh, release the other ranks' ``follow``
        even when no runner ran."""
        with self._runner_lock:
            runner, self._runner = self._runner, None
        lead = self._multi_rank and self.mesh.is_first
        if runner is None:
            if lead:
                from copilot_for_consensus_tpu_torch.engine import (
                    mesh_runner,
                )
                mesh_runner.release_followers(self.engine,
                                              final=drain_s is None)
            return True
        drained = runner.drain(drain_s) if drain_s is not None else True
        if lead:
            runner.stop(final=drain_s is None)
        else:
            runner.stop()
        return drained

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Graceful drain: wait up to ``deadline_s`` for the runner to
        finish its queued and active work, then stop it. True when the
        engine fully drained (and when no runner was started). On rank 0
        of a mesh, drainedness is rank 0's, on its clock; the stop then
        ends the other ranks' ``follow``."""
        return self._end(deadline_s)

    def close(self) -> None:
        """Stop the runner, if one was started; outstanding handles fail
        with "runner stopped". On rank 0 of a mesh the other ranks'
        ``follow`` returns with ``closed``."""
        if self._multi_rank and not self.mesh.is_first:
            return
        self._end(None)
