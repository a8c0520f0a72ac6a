"""Asynchronous serving front-end for the generation engine.

The engine itself is synchronous and single-owner (one thread drives
``submit()`` + ``step()``); in-process services interleave their own
work (bus I/O, prompt building, report writes) with stepping, so the
device idles whenever the service is busy. This runner gives the engine
a dedicated dispatcher thread that owns ALL device interaction and
keeps the chip busy whenever there is work:

* callers ``submit()`` from any thread and get a handle they can wait
  on; tokenization/prompt prep stays on the caller's thread and
  overlaps the device's current decode dispatch;
* the dispatcher admits every pending request a free slot can take as
  ONE batched prefill wave between decode dispatches (the engine's
  wave batching amortizes the weight pass over all arrivals that
  accumulated during the last window);
* completions resolve caller handles as soon as their dispatch
  harvests.

True device-side overlap of prefill and decode is not possible on a
single chip (programs serialize; this backend additionally blocks
inside the dispatch call — a window-pipelining experiment showed it), so
the steady-state duty cycle is decode_time / (decode_time +
admission_time) — what ``scripts/bench_poisson.py`` measures against
the batch bench.

Resilience (``supervisor=``, engine/supervisor.py;
docs/RESILIENCE.md): with a supervisor attached, an engine failure no
longer loses every in-flight request. The watchdog converts a HUNG
dispatch into a contained engine-suspect event (in-engine handles fail
with a structured :class:`~.supervisor.EngineSuspect`; pending submits
survive and serve after recovery), and a FAILED dispatch triggers
containment + request replay: each evacuated request's accepted tokens
already live host-side, so survivors resubmit as
prompt+generated-so-far continuations (greedy bit-identical) under a
per-request retry budget, with a structured
:class:`~.supervisor.EngineFailed` (correlation id + flight-record
path) only when the budget is spent.

Reference comparison: the reference's summarization service holds ONE
blocking HTTP connection per summary (``local_llm_summarizer.py:106``);
this is the first-party continuous-batching replacement's front door —
and the supervisor is its stand-in for the crash isolation the
reference gets from RabbitMQ redelivery when an inference container
dies (SURVEY §0).

The port's copy of the JAX package's ``engine/async_runner.py``, over the
port's engine and supervisor. On the card the dispatcher thread is also
the thread that captures and replays the engine's decode CUDA graphs
(``engine/graphs.py``): it is the engine's single owner, so a graph is
only ever captured, replayed or dropped there, and the engine captures
in ``thread_local`` mode so that a submitter thread's CUDA calls cannot
break a capture. The port's engine has no scheduler, telemetry or
journal yet: every hook of theirs is read with ``getattr``, and a
request's ``tenant``, ``priority`` and ``deadline_at`` too. Nothing in
the port opens a pipeline trace span yet, so a handle carries no trace
parent and a replay annotates no trace.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from copilot_for_consensus_tpu_torch.engine.generation import (
    Completion,
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    EngineFailed,
    EngineSuspect,
    resolve_supervisor,
)


@dataclass
class Handle:
    """Caller-side future for one request."""

    request_id: int = -1
    correlation_id: str = ""
    created_at: float = field(default_factory=time.monotonic)
    _event: threading.Event = field(default_factory=threading.Event)
    _completion: Completion | None = None
    _error: BaseException | None = None
    _callbacks: list = field(default_factory=list)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Completion:
        if not self._event.wait(timeout):
            # Enriched timeout: name the request so the caller can
            # join the flight-recorder dump / engine telemetry span
            # without guessing which of its handles this was.
            elapsed = time.monotonic() - self.created_at
            raise TimeoutError(
                f"generation not finished after {elapsed:.1f}s "
                f"(request_id={self.request_id}, "
                f"correlation_id={self.correlation_id or '<none>'}, "
                f"timeout={timeout}s)")
        if self._error is not None:
            raise self._error
        assert self._completion is not None
        return self._completion

    def add_done_callback(self, fn) -> None:
        """Run ``fn(handle)`` when the request resolves (completion OR
        failure). Fires on the dispatcher thread; if already resolved,
        fires immediately on the calling thread.

        This is the GIL-friendly harvest path: a waiter that POLLS
        ``done()`` across many handles wakes the interpreter constantly
        and steals cycles from the dispatch call itself (the measured
        serving-mode host tax, docs/PERF.md); a callback costs one
        invocation per completion and nothing in between."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        # Already resolved: fire now, under the SAME containment as
        # _finish — whether an observer error is swallowed must not
        # depend on the registration/resolution race.
        try:
            fn(self)
        except Exception:
            pass    # a broken observer must not kill the caller

    def _resolve(self, completion: Completion) -> None:
        self._completion = completion
        self._finish()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._finish()

    def _finish(self) -> None:
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                pass    # a broken observer must not kill the dispatcher


@dataclass
class _ReplayState:
    """Per-handle replay bookkeeping (keyed by the CURRENT engine
    request id): the original request's identity so a stitched
    completion reports the caller's prompt length and full token
    stream, not the continuation's."""

    prompt_len: int
    max_new_tokens: int
    tokens: list[int]          # accepted across all prior attempts
    attempts: int = 0


class AsyncEngineRunner:
    """Dispatcher thread owning a ``GenerationEngine``'s device calls.

    ``error_reporter`` (``obs/errors.py``) receives engine failures
    with the flight-recorder context: the correlation ids of the
    requests that were in flight and the dump path when the engine's
    telemetry wrote one — an engine error report that cannot name its
    victims is a post-mortem with the body missing.

    ``supervisor`` (``engine/supervisor.py``): None/False disables
    (legacy fail-all containment), True builds one with defaults, a
    ``SupervisorConfig``/``EngineSupervisor`` wires watchdog deadlines,
    invariant audits, request replay and the degraded-mode breakers.
    Its watchdog thread starts/stops with the runner."""

    def __init__(self, engine: GenerationEngine, *,
                 error_reporter=None, supervisor=None):
        self.engine = engine
        self.error_reporter = error_reporter
        self.supervisor = resolve_supervisor(supervisor, engine)
        if self.supervisor is not None:
            self.supervisor.set_suspect_callback(self._on_suspect)
        self._pending: list[
            tuple[list[int], int, int | None, str, Handle]] = []
        self._handles: dict[int, Handle] = {}
        self._replays: dict[int, _ReplayState] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        #: set by stop(): wakes a drain() poll so shutdown never waits
        #: out the full drain deadline
        self._stop_evt = threading.Event()
        #: submits popped off _pending but not yet registered in
        #: _handles (the dispatcher's handoff window) — drain() must
        #: not read that instant as idle
        self._admitting = 0
        self._thread: threading.Thread | None = None
        #: monotonic start of the in-progress eng.step(), None when idle
        #: — what stop() names when the dispatcher fails to join
        self._step_t0: float | None = None
        #: dispatcher-loop stats for benches/metrics
        self.completed = 0
        self.decode_busy_s = 0.0
        #: resilience counters (recovery_stats())
        self.replayed = 0          # continuation resubmissions
        self.recovered = 0         # completions that needed >=1 replay
        self.replay_failed = 0     # EngineFailed (budget spent)
        self.suspect_failures = 0  # handles failed by the watchdog
        self._last_dump_path = ""

    # -- caller side ----------------------------------------------------

    def start(self) -> "AsyncEngineRunner":
        if self._thread is not None:
            raise RuntimeError("runner already started")
        if self.supervisor is not None and getattr(
                self.engine, "journal_replayed", 0):
            # Restart-time audit (docs/RESILIENCE.md#process-lifecycle):
            # the engine warm-restarted from a non-empty journal, so
            # verify/repair its host invariants BEFORE the dispatcher
            # takes ownership — the same audit that runs after a
            # contained in-process failure. This thread still owns the
            # engine here (the dispatcher has not started).
            self.supervisor.audit(repair=True)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-dispatch")
        self._thread.start()
        if self.supervisor is not None:
            self.supervisor.start()
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the dispatcher. Returns True when the thread joined
        cleanly; False when it did NOT (a hung dispatch) — in that
        case every outstanding handle is failed with a structured
        :class:`EngineSuspect` naming the stuck dispatch state, the
        condition is logged, and the daemon thread is abandoned rather
        than silently leaving callers to sit out their full
        ``result()`` timeouts."""
        fi = getattr(self.engine, "faults", None)
        if fi is not None:
            # shutdown must never wait out a scripted chaos hang
            fi.release_hangs()
        self._stop_evt.set()
        with self._work:
            self._stop = True
            self._work.notify()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                joined = False
                state = self._dispatch_state()
                exc = EngineSuspect(
                    f"runner stopped but the dispatcher thread failed "
                    f"to join within {timeout:.1f}s; stuck in {state} — "
                    f"outstanding handles failed, thread abandoned "
                    f"(daemon)", kind="stop",
                    elapsed_s=self._step_elapsed(),
                    deadline_s=timeout)
                self._fail_outstanding(exc)
                try:
                    from copilot_for_consensus_tpu_torch.obs.logging import (
                        get_logger,
                    )
                    get_logger().error("engine dispatcher failed to "
                                       "join on stop", state=state,
                                       timeout_s=timeout)
                except Exception:
                    pass   # logging must not mask the condition
            self._thread = None
        if joined:
            # Evacuate-and-journal: with the dispatcher joined this
            # thread owns the engine again — checkpoint every active
            # slot's accepted tokens so the rows a warm restart resumes
            # from are as fresh as the work was. Rows are NOT abandoned
            # on stop: a stop is the crash-only discipline's clean
            # case, and the journal is what makes restart cost latency
            # instead of work.
            self._journal_checkpoint_remaining()
        if self.supervisor is not None:
            self.supervisor.stop()
        return joined

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful-drain wait (services/lifecycle.py): block until the
        engine has no pending submits, no outstanding handles and no
        queued/active work, or ``timeout`` expires. Returns True when
        fully drained. On False the caller proceeds to :meth:`stop`,
        which checkpoints the remaining work's accepted tokens into
        the journal — evacuate-and-journal — so the next process
        resumes it. Stop-aware: a concurrent ``stop()`` ends the wait
        immediately."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._work:
                idle = (not self._pending and not self._handles
                        and not self._admitting
                        and self._engine_idle(self.engine))
            if idle:
                return True
            if self._stop_evt.wait(0.02):
                break
        return False

    def _journal_checkpoint_remaining(self) -> None:
        """Best-effort final checkpoint of every active slot (engine-
        owner thread only — callers hold ownership: stop() after a
        clean join)."""
        j = getattr(self.engine, "journal", None)
        if j is None:
            return
        try:
            pairs = []
            for slot, req in getattr(self.engine, "_active",
                                     {}).items():
                gen = self.engine._generated.get(slot)
                if gen:
                    pairs.append((req.request_id, gen))
            if pairs:
                j.checkpoint_many(pairs)
        except Exception:
            pass    # journaling must never break shutdown

    def _journal_abandon(self, request_ids) -> None:
        """Delete journal rows for requests whose terminal structured
        failure was DELIVERED to a live caller — the caller owns the
        retry; replaying at the next restart would duplicate work the
        caller already saw fail."""
        j = getattr(self.engine, "journal", None)
        if j is None:
            return
        stitch = getattr(self.engine, "_journal_stitch", None)
        ckpt = getattr(self.engine, "_journal_ckpt", None)
        for rid in request_ids:
            if rid is None or rid < 0:
                continue    # never submitted: no row exists
            try:
                j.record_abandon(rid)
            except Exception:
                pass    # journaling must never mask the failure
            # prune the engine-side per-rid bookkeeping too, or a
            # long-lived process leaks one entry per abandoned request
            # (dict pops are GIL-atomic; stale-miss is harmless)
            if stitch is not None:
                stitch.pop(rid, None)
            if ckpt is not None:
                ckpt.pop(rid, None)

    def _step_elapsed(self) -> float:
        t0 = self._step_t0
        return time.monotonic() - t0 if t0 is not None else 0.0

    def _dispatch_state(self) -> str:
        """Human-readable description of what the dispatcher is stuck
        in — the supervisor's innermost dispatch frame when one is
        active, else the coarse step timing."""
        if self.supervisor is not None:
            cur = self.supervisor.current_dispatch()
            if cur is not None:
                kind, t0 = cur
                return (f"dispatch:{kind} "
                        f"({time.monotonic() - t0:.1f}s)")
        if self._step_t0 is not None:
            return f"engine.step() ({self._step_elapsed():.1f}s)"
        return "idle (not inside a dispatch)"

    def submit(self, prompt: list[int],
               max_new_tokens: int = 256, *,
               cache_eligible_tokens: int | None = None,
               correlation_id: str = "", tenant: str = "",
               priority: str = "",
               deadline_s: float | None = None) -> Handle:
        """Thread-safe enqueue; returns a waitable handle.
        ``cache_eligible_tokens`` plumbs through to
        ``GenerationEngine.submit`` (prefix-cache publish cap);
        ``correlation_id`` tags the request's telemetry span;
        ``tenant``/``priority`` feed the engine's scheduler when one is
        configured; ``deadline_s`` is the per-request wall-clock budget
        (expired work is dropped, not computed — the handle resolves
        with ``finish_reason="deadline"``).

        Load shedding happens HERE, synchronously: an overloaded
        scheduler raises ``EngineOverloaded`` on the caller's thread
        (so the service can answer 429 + Retry-After immediately)
        instead of handing back a handle doomed to fail a dispatch
        cycle later. The engine's own submit re-checks on the
        dispatcher thread — this pre-check reads only the scheduler's
        shed state, which is GIL-safe counter reads."""
        if self._thread is None:
            raise RuntimeError("runner not started")
        sched = getattr(self.engine, "_sched", None)
        if sched is not None:
            sched.check_admission(
                tenant=tenant, priority=priority or "interactive",
                prompt_tokens=len(prompt),
                correlation_id=correlation_id)
        h = Handle(correlation_id=correlation_id)
        kw: dict = {}
        if cache_eligible_tokens is not None:
            kw["cache_eligible_tokens"] = cache_eligible_tokens
        if correlation_id:
            kw["correlation_id"] = correlation_id
        if tenant:
            kw["tenant"] = tenant
        if priority:
            kw["priority"] = priority
        if deadline_s is not None:
            kw["deadline_s"] = deadline_s
        with self._work:
            if self._stop:
                # a submit racing stop() must not enqueue a handle the
                # (exiting) dispatcher will never resolve
                raise RuntimeError("runner stopped")
            self._pending.append((prompt, max_new_tokens, kw, h))
            self._work.notify()
        return h

    def prefix_stats(self) -> dict:
        """Prefix-cache counters passthrough (counter reads are atomic
        enough for metrics; no engine lock is taken)."""
        return self.engine.prefix_stats()

    def recovery_stats(self) -> dict:
        """Resilience ledger for benches/metrics (mirrors
        ``prefix_stats``): replay/recovery counters plus the
        supervisor's watchdog/breaker/audit state when one is wired."""
        out = {
            "replayed": self.replayed,
            "recovered": self.recovered,
            "failed": self.replay_failed,
            "suspect_failures": self.suspect_failures,
        }
        j = getattr(self.engine, "journal", None)
        if j is not None:
            out["journal"] = j.stats()
            out["journal_replayed"] = getattr(
                self.engine, "journal_replayed", 0)
        if self.supervisor is not None:
            s = self.supervisor.stats()
            out["watchdog_trips"] = s["watchdog_trips"]
            out["containments"] = s["containments"]
            out["released_pins"] = s["released_pins"]
            out["quarantined_slots"] = s["quarantined_slots"]
            out["breaker_trips"] = sum(
                b["trips"] for b in s["breakers"].values())
            out["breakers"] = s["breakers"]
        return out

    # -- dispatcher side ------------------------------------------------

    @staticmethod
    def _engine_idle(eng) -> bool:
        """No work anywhere in the engine: active slots, engine queue,
        piggyback feed, AND (scheduler engines) the scheduler's tenant
        queues / chunked-prefill streams — a request parked in a tenant
        queue still needs step() calls to ever be released."""
        if eng._active or eng._queue or getattr(eng, "_prefilling",
                                                None):
            return False
        if getattr(eng, "_chunking", None) \
                or getattr(eng, "_chunk_pending", None):
            return False
        if getattr(eng, "_done", None):
            # completions parked for harvest (e.g. journal-recovered
            # rows that were already fully generated): one more step()
            # drains them and retires their journal rows
            return False
        sched = getattr(eng, "_sched", None)
        return sched is None or sched.queued == 0

    def _loop(self) -> None:
        eng = self.engine
        sup = self.supervisor
        while True:
            with self._work:
                while (not self._stop and not self._pending
                       and self._engine_idle(eng)):
                    self._work.wait(timeout=0.1)
                if self._stop:
                    stopping = True
                else:
                    stopping = False
                    fresh = self._pending
                    self._pending = []
                    self._admitting = len(fresh)
            if stopping:
                # Fail every outstanding handle promptly — a caller
                # blocked in result() must not sit out its full
                # timeout just because the runner was stopped. (The
                # sweep re-takes the lock internally and fires the
                # failures outside it — done-callbacks may re-enter
                # submit.)
                self._fail_outstanding(RuntimeError("runner stopped"))
                return
            # Enqueue arrivals into the engine on the dispatcher thread
            # (the engine is single-owner; only this thread touches it).
            # A bad request (e.g. empty prompt) fails ITS handle, not
            # the loop — an unhandled exception here would kill the
            # dispatcher and hang every outstanding and future handle.
            # A scheduler shed (EngineOverloaded) fails the handle the
            # same contained way: it is an ADMISSION outcome, so it
            # must not trip the engine-failure path below (no flight-
            # recorder dump, no error_reporter post-mortem).
            for prompt, mnt, kw, h in fresh:
                try:
                    # kwargs only when set: duck-typed engine stands-in
                    # (tests, shims) keep their 2-arg submit signature
                    rid = eng.submit(prompt, mnt, **kw)
                except Exception as exc:
                    h._fail(exc)
                    with self._work:
                        self._admitting -= 1
                    continue
                h.request_id = rid
                # _handles/_replays are shared with the watchdog
                # thread's _on_suspect — every mutation holds the lock
                with self._work:
                    self._handles[rid] = h
                    self._admitting -= 1
            t0 = time.monotonic()
            self._step_t0 = t0
            if sup is not None:
                # coarse watchdog frame over the whole step; the
                # engine's _dispatch_boundary nests the precise kind
                sup.begin_dispatch("step")
            try:
                comps = eng.step()  # admit wave + one decode dispatch
            except Exception as exc:
                # Device/engine failure. Flight recorder dumps FIRST
                # (it names the requests in flight by correlation id),
                # then the error reporter gets the dump context. With a
                # supervisor: containment + request replay — surviving
                # requests continue from their host-side accepted
                # tokens instead of being lost. Without: the legacy
                # fail-all containment. Either way the dispatcher
                # stays alive for new work.
                self._report_engine_error(exc)
                if sup is not None:
                    self._recover(exc)
                else:
                    # legacy fail-all containment: sweep under the
                    # lock (shared with the watchdog-less stop path),
                    # fail OUTSIDE it — done-callbacks may re-enter
                    # submit()
                    with self._work:
                        victims = list(self._handles.values())
                        self._handles.clear()
                    for h in victims:
                        h._fail(exc)
                    self._journal_abandon(
                        h.request_id for h in victims)
                continue
            finally:
                if sup is not None:
                    sup.end_dispatch("step")
                self._step_t0 = None
                self.decode_busy_s += time.monotonic() - t0
            if sup is not None:
                sup.on_step_ok()
            for c in comps:
                self.completed += 1
                # pop under the lock (shared with the watchdog's
                # _on_suspect); resolve OUTSIDE it — done-callbacks may
                # re-enter submit(), which takes the same lock
                with self._work:
                    h = self._handles.pop(c.request_id, None)
                    meta = self._replays.pop(c.request_id, None)
                if h is None:
                    continue   # watchdog failed this handle mid-hang
                if meta is not None:
                    # Stitch the continuation onto the original
                    # identity: the caller sees ONE completion with its
                    # own prompt length and the full token stream.
                    c = Completion(
                        request_id=c.request_id,
                        prompt_len=meta.prompt_len,
                        tokens=meta.tokens + c.tokens,
                        finish_reason=c.finish_reason,
                        prefill_s=c.prefill_s, decode_s=c.decode_s)
                    self.recovered += 1
                h._resolve(c)
            if sup is not None and sup.take_suspect():
                # The watchdog tripped during a step that then returned
                # on its own: the in-engine waiters were failed by the
                # callback, so the engine's surviving work — active
                # slots AND queued requests — is zombie compute.
                # Evacuate and purge it rather than burning dispatches
                # on requests nobody is waiting for; any handle the
                # callback RACED past (submitted between the trip and
                # this cleanup) is failed here with the same structured
                # error, never left to strand until its timeout.
                exc = sup.last_suspect or EngineSuspect(
                    "engine suspect (watchdog)")
                dropped = [req for req, _gen in sup.evacuate()]
                dropped += sup.purge_queued()
                for req in dropped:
                    rid = getattr(req, "request_id", None)
                    with self._work:
                        h = self._handles.pop(rid, None)
                        self._replays.pop(rid, None)
                    if h is not None:
                        h._fail(exc)
                self._journal_abandon(
                    getattr(req, "request_id", None) for req in dropped)
                sup.audit(repair=True)

    # -- failure handling ------------------------------------------------

    def _on_suspect(self, exc: EngineSuspect) -> None:
        """Watchdog callback (WATCHDOG THREAD): a dispatch overran its
        deadline and the dispatcher is stuck inside it. Fail the
        in-engine handles structured so their callers unwedge NOW;
        pending submits never touched the suspect engine, so they stay
        queued and serve after the dispatcher recovers — which is what
        keeps the front door live through a bounded hang. Handles are
        popped under the lock but failed OUTSIDE it: done-callbacks
        may re-enter submit(), which takes the same lock."""
        with self._work:
            victims = list(self._handles.values())
            self._handles.clear()
            self._replays.clear()
        for h in victims:
            h._fail(exc)
        self._journal_abandon(h.request_id for h in victims)
        self.suspect_failures += len(victims)

    def _recover(self, exc: BaseException) -> None:
        """Containment + replay after a failed step (DISPATCHER
        THREAD). The supervisor evacuates every active/chunking slot
        and repairs the engine's invariants; each evacuated request
        either resubmits as a prompt+generated continuation (budget
        permitting) or fails with a structured EngineFailed naming the
        correlation id and the flight-record dump."""
        sup = self.supervisor
        tele = getattr(self.engine, "telemetry", None)
        plan = sup.contain(exc)
        if plan.suspect:
            # The watchdog already failed EVERY in-engine handle
            # (including queued requests') while this step hung — the
            # engine's queued work is waiterless now; drop it instead
            # of computing it for nobody (failing any handle the trip
            # callback raced past).
            exc_s = sup.last_suspect or EngineSuspect(
                "engine suspect (watchdog)")
            purged = sup.purge_queued()
            for req in purged:
                rid = getattr(req, "request_id", None)
                with self._work:
                    h = self._handles.pop(rid, None)
                    self._replays.pop(rid, None)
                if h is not None:
                    h._fail(exc_s)
            self._journal_abandon(
                getattr(req, "request_id", None) for req in purged)
        budget = sup.cfg.replay_budget
        for req, gen in plan.evacuated:
            with self._work:
                h = self._handles.pop(req.request_id, None)
                meta = self._replays.pop(req.request_id, None)
            if h is None:
                continue   # watchdog already failed this handle
            if meta is None:
                meta = _ReplayState(prompt_len=len(req.prompt),
                                    max_new_tokens=req.max_new_tokens,
                                    tokens=[])
            tokens = meta.tokens + list(gen)
            attempts = meta.attempts + 1
            remaining = meta.max_new_tokens - len(tokens)
            if remaining <= 0:
                # The failed step had already harvested this request's
                # FULL output (multi-window dispatches land all their
                # tokens before the failing window raises): everything
                # the caller asked for exists host-side — resolve it,
                # don't burn a replay or fail it.
                if meta.attempts:
                    self.recovered += 1
                h._resolve(Completion(
                    request_id=req.request_id,
                    prompt_len=meta.prompt_len,
                    tokens=tokens[:meta.max_new_tokens],
                    finish_reason="length"))
                j = getattr(self.engine, "journal", None)
                if j is not None:
                    try:
                        # completed, just harvested off the failure
                        # path: the row retires like any completion
                        j.record_retire(req.request_id)
                    except Exception:
                        pass
                continue
            limit = getattr(self.engine, "prompt_limit", None)
            if attempts > budget or (
                    limit is not None
                    and len(req.prompt) + len(gen) > limit):
                # Budget spent — or the continuation no longer FITS
                # (prompt+generated past prompt_limit): submit would
                # silently head-truncate it and the replay would
                # diverge from the fault-free stream, which is worse
                # than an honest structured failure.
                reason = ("replay-budget" if attempts > budget
                          else "continuation-too-long")
                self.replay_failed += 1
                if tele is not None:
                    tele.on_replay_failed()
                h._fail(EngineFailed(
                    f"request {req.request_id} lost to engine failure "
                    f"after {attempts - 1} replay(s) "
                    f"({reason}, budget {budget}): "
                    f"{type(exc).__name__}: {exc}",
                    request_id=req.request_id,
                    correlation_id=req.correlation_id,
                    attempts=attempts - 1, reason=reason,
                    flight_record=self._last_dump_path))
                self._journal_abandon([req.request_id])
                continue
            kw: dict = {}
            if req.cache_eligible_tokens is not None:
                kw["cache_eligible_tokens"] = req.cache_eligible_tokens
            if req.correlation_id:
                kw["correlation_id"] = req.correlation_id
            if getattr(req, "tenant", ""):
                kw["tenant"] = req.tenant
            if getattr(req, "priority", ""):
                kw["priority"] = req.priority
            deadline_at = getattr(req, "deadline_at", float("inf"))
            if deadline_at != float("inf"):
                kw["deadline_s"] = max(0.0, deadline_at - time.monotonic())
            j = getattr(self.engine, "journal", None)
            try:
                # The continuation: everything accepted so far becomes
                # prompt (seeded prefill re-derives the KV the failed
                # cache held; greedy decode continues bit-identically —
                # the chunked-prefill identity argument,
                # docs/RESILIENCE.md). With a journal, the
                # continuation's row is the ATOMIC supersede re-key of
                # the original's below — record_submit is suppressed so
                # the journal never holds two live rows for one
                # request (a crash anywhere here replays exactly one).
                if j is not None:
                    self.engine._journal_suppress = True
                try:
                    new_rid = self.engine.submit(
                        list(req.prompt) + list(gen), remaining, **kw)
                finally:
                    if j is not None:
                        self.engine._journal_suppress = False
            except Exception as sub_exc:
                # e.g. EngineOverloaded while shedding under the
                # lowered cap — structured, honest, final for this
                # handle
                h._fail(sub_exc)
                self._journal_abandon([req.request_id])
                continue
            h.request_id = new_rid
            if j is not None:
                try:
                    # re-key the journal row onto the continuation so
                    # a PROCESS death mid-replay still recovers the
                    # original request identity
                    j.supersede(req.request_id, new_rid, tokens)
                except Exception:
                    pass
            with self._work:
                self._handles[new_rid] = h
                self._replays[new_rid] = _ReplayState(
                    prompt_len=meta.prompt_len,
                    max_new_tokens=meta.max_new_tokens,
                    tokens=tokens, attempts=attempts)
            self.replayed += 1
            if tele is not None:
                tele.on_replay()
        if sup.unhealthy:
            # Persistent failure mode: queued work that admit-wave
            # unwinds keep requeuing never touches the replay budget,
            # so without this gate a permanently failing dispatch
            # would raise/requeue forever while callers hang to their
            # own timeouts. Declare the engine unhealthy: fail every
            # outstanding handle structured and purge the queues —
            # the dispatcher stays alive for traffic submitted after
            # the fault clears (a success resets the counter).
            term = EngineFailed(
                f"engine unhealthy: {sup.consecutive_failures} "
                f"consecutive failed steps (last: "
                f"{type(exc).__name__}: {exc})",
                reason="engine-unhealthy",
                flight_record=self._last_dump_path)
            self.suspect_failures += self._fail_outstanding(
                term, abandon_journal=True)
            purged = sup.purge_queued()
            self._journal_abandon(
                getattr(req, "request_id", None) for req in purged)

    def _fail_outstanding(self, exc: BaseException, *,
                          abandon_journal: bool = False) -> int:
        """Fail every pending and in-engine handle with ``exc``
        (lock-held sweep shared by the watchdog callback and the
        unhealthy terminal gate). Returns how many were failed.
        ``abandon_journal=True`` (the TERMINAL sweeps: unhealthy,
        suspect) also deletes the victims' journal rows — the callers
        were told, so a restart must not replay their work. The STOP
        sweeps leave rows in place: stop is the crash-only clean case
        and the journal is what a warm restart resumes from."""
        with self._work:
            victims = ([h for *_r, h in self._pending]
                       + list(self._handles.values()))
            self._pending.clear()
            self._handles.clear()
            self._replays.clear()
        for h in victims:
            h._fail(exc)
        if abandon_journal:
            self._journal_abandon(h.request_id for h in victims)
        return len(victims)

    def _report_engine_error(self, exc: BaseException) -> None:
        """Flight-recorder dump + error report for a failed dispatch.
        Best-effort on both counts — observability must never mask or
        amplify the engine failure it is describing."""
        tele = getattr(self.engine, "telemetry", None)
        dump = None
        if tele is not None:
            try:
                dump = tele.record_error(exc)
            except Exception:
                pass
        self._last_dump_path = (dump or {}).get("dump_path", "") \
            if isinstance(dump, dict) else ""
        if self.error_reporter is None:
            return
        context: dict = {"component": "engine-dispatch"}
        if dump is not None:
            context["correlation_ids"] = dump.get("correlation_ids", [])
            context["requests_in_flight"] = len(dump.get("in_flight",
                                                         []))
            if "dump_path" in dump:
                context["flight_record"] = dump["dump_path"]
        try:
            self.error_reporter.report(exc, context)
        except Exception:
            pass
