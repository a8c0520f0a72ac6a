"""Engine supervisor: watchdog, crash containment, degraded modes.

``async_runner.py`` used to say it outright: "Device/engine failure:
every in-flight request is lost" — and a hung ``eng.step()`` wedged the
dispatcher forever with no watchdog. This module is the recovery layer
for the in-process engine, the first-party replacement for the crash
isolation the reference pipeline gets from its broker (a dead Ollama
container → RabbitMQ redelivers; SURVEY §0). Four pieces:

* **Watchdog** — a stop-aware thread with per-dispatch-kind wall-time
  deadlines. The runner publishes a coarse ``step`` frame around
  ``eng.step()`` and the engine's ``_dispatch_boundary`` nests the
  precise kind (``decode``/``verify``/...); when the innermost frame
  overruns its deadline the engine is marked SUSPECT and the
  registered callback fires (the async runner fails the in-engine
  handles with a structured :class:`EngineSuspect`) — callers unwedge
  immediately instead of sitting out their full ``result()`` timeouts
  behind a stuck device call.
* **Crash containment** — after a failed step, :meth:`contain`
  evacuates every active slot (requests + their host-side accepted
  tokens survive), then :meth:`audit` checks the engine's invariants
  (slot table vs active set, prefix-cache pin refcounts, scheduler
  queue accounting), releases leaked pins, repairs the bookkeeping it
  can, and QUARANTINES slots whose state cannot be reconciled. A
  failure that may have corrupted device state (anything that is not
  an :class:`~.faults.InjectedFault`, which fires strictly at the host
  boundary) also flushes the prefix-cache pool — reused blocks of
  unknown integrity must never seed a future admission.
* **Request replay** — the evacuated ``(request, generated)`` pairs go
  back to the runner, which resubmits survivors as
  prompt+generated-so-far continuations (seeded prefill; greedy
  bit-identical — the same cross-path-identity argument as chunked
  prefill, docs/SCHEDULER.md) under a per-request retry budget, with a
  structured :class:`EngineFailed` (correlation id + flight-record
  path) only when the budget is spent.
* **Degraded modes** — circuit breakers. Repeated verify-dispatch
  failures open the ``spec_verify`` breaker: the engine falls back to
  plain windowed decode (served traffic keeps completing) and a
  half-open probe re-enables speculation when faults clear. Repeated
  resource exhaustion opens the ``resource`` breaker: the engine's
  occupancy cap halves and the scheduler's shed loop is informed
  (``Scheduler.pressure``), recovering by doubling the cap back per
  successful half-open probe.

Everything here is import-light host code (no jax): the service layer
imports :class:`EngineFailed`/:class:`EngineSuspect` for its error
mapping without touching the device stack, and the policy is
unit-testable against stub engines. State-mutating methods
(:meth:`contain`, :meth:`evacuate`, :meth:`audit`) MUST run on the
thread that owns the engine (the runner's dispatcher) — the watchdog
thread itself only reads its own frame stack and flips flags.
Design notes: ``docs/RESILIENCE.md``.

The port's copy of the JAX package's ``engine/supervisor.py``. The port's
engine has no disaggregated roles yet, so the member they add
(``_handoff``) is read with ``getattr``, and ``set_slot_cap`` is called
behind ``hasattr`` where the reference calls it outright. Two additions: a
repairing :meth:`audit` ends with the engine's ``on_repaired`` hook, which
lets an engine that dropped its decode graphs after a failed dispatch
capture them again; and over a mesh of several ranks
(``engine/mesh_runner.py``) the supervisor's verdicts are rank 0's. There
each outermost :meth:`contain`, :meth:`evacuate`, :meth:`purge_queued` and
:meth:`audit` goes into the engine's operation log with what it did, and
every other rank applies it through a :class:`FollowerSupervisor`, which
decides nothing and reads no clock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from copilot_for_consensus_tpu_torch.engine.faults import InjectedFault


class EngineSuspect(RuntimeError):
    """The watchdog declared the engine suspect: a dispatch overran its
    deadline. Carries the stuck dispatch's kind and timing so a failed
    handle names the state it died behind."""

    def __init__(self, message: str, *, kind: str = "",
                 elapsed_s: float = 0.0, deadline_s: float = 0.0,
                 correlation_id: str = ""):
        super().__init__(message)
        self.kind = kind
        self.elapsed_s = float(elapsed_s)
        self.deadline_s = float(deadline_s)
        self.correlation_id = correlation_id

    def as_event_fields(self) -> dict:
        return {
            "error": str(self),
            "reason": "engine-suspect",
            "kind": self.kind,
            "elapsed_s": round(self.elapsed_s, 3),
            "deadline_s": round(self.deadline_s, 3),
            "correlation_id": self.correlation_id,
        }


class EngineFailed(RuntimeError):
    """Terminal structured failure for ONE request: its replay budget
    is spent. Carries the correlation id and the flight-record dump
    path so the caller (and the error event) can join the post-mortem
    without grepping logs."""

    def __init__(self, message: str, *, request_id: int = -1,
                 correlation_id: str = "", attempts: int = 0,
                 flight_record: str = "", reason: str = "replay-budget"):
        super().__init__(message)
        self.request_id = request_id
        self.correlation_id = correlation_id
        self.attempts = attempts
        self.flight_record = flight_record
        self.reason = reason

    def as_event_fields(self) -> dict:
        return {
            "error": str(self),
            "reason": self.reason,
            "request_id": self.request_id,
            "correlation_id": self.correlation_id,
            "attempts": self.attempts,
            "flight_record": self.flight_record,
        }


#: RuntimeError markers XLA uses for allocation failure — the resource
#: breaker's classification (substring match on the message)
_RESOURCE_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory",
                     "out of memory", "OOM")


def is_resource_exhaustion(exc: BaseException) -> bool:
    # KVPoolExhausted (engine/kv_pool.py) self-classifies: a dry block
    # pool is capacity pressure, not corruption — the resource breaker
    # (lowered admission cap) is the right response.
    if getattr(exc, "resource_exhausted", False):
        return True
    msg = str(exc)
    return isinstance(exc, MemoryError) or any(
        m in msg for m in _RESOURCE_MARKERS)


@dataclass(frozen=True)
class SupervisorConfig:
    """Policy knobs. Deadlines are generous by default — the watchdog
    exists to catch a WEDGED tunnel/device (minutes of silence), not a
    slow compile; chaos tests tighten them to milliseconds."""

    #: per-dispatch-kind wall-time deadline; ``step`` covers the
    #: runner's whole ``eng.step()`` frame (compile included, hence
    #: the larger default)
    deadlines_s: dict[str, float] = field(default_factory=dict)
    default_deadline_s: float = 120.0
    step_deadline_s: float = 600.0
    watchdog_poll_s: float = 0.05
    #: replays one request may consume before EngineFailed
    replay_budget: int = 2
    #: consecutive verify failures that open the spec-decode breaker
    verify_breaker_threshold: int = 3
    #: consecutive resource-exhaustion failures that open the resource
    #: breaker (each trip halves the occupancy cap)
    resource_breaker_threshold: int = 2
    #: open → half-open probe delay, both breakers
    breaker_probe_after_s: float = 30.0
    #: resource breaker never lowers the cap below this many slots
    min_slot_cap: int = 1
    #: consecutive failed steps (no successful dispatch in between)
    #: after which the engine is declared UNHEALTHY: outstanding
    #: handles fail structured and queued work purges, instead of a
    #: persistently failing admission wave requeue/raise-looping
    #: forever with callers stuck to their own timeouts
    max_consecutive_failures: int = 8

    def deadline_for(self, kind: str) -> float:
        if kind == "step":
            return self.deadlines_s.get("step", self.step_deadline_s)
        return self.deadlines_s.get(kind, self.default_deadline_s)


class CircuitBreaker:
    """closed → open (after ``threshold`` consecutive failures) →
    half-open (one probe allowed after ``probe_after_s``) → closed on
    probe success / re-open on probe failure. Gauge encoding (the
    ``copilot_engine_fault_breaker_state`` series and the
    ``EngineDegradedMode`` alert): closed 0, half-open 0.5, open 1."""

    GAUGE = {"closed": 0.0, "half-open": 0.5, "open": 1.0}

    def __init__(self, name: str, *, threshold: int,
                 probe_after_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.threshold = max(1, int(threshold))
        self.probe_after_s = float(probe_after_s)
        self._clock = clock
        self.state = "closed"
        self.failures = 0           # consecutive, in the closed state
        self.trips = 0
        self.opened_at = 0.0

    def allow(self) -> bool:
        """May the protected operation run right now? Open flips to
        half-open (the probe) once the cooldown elapses."""
        if self.state == "closed":
            return True
        if self.state == "open" and \
                self._clock() - self.opened_at >= self.probe_after_s:
            self.state = "half-open"
        return self.state == "half-open"

    def record_failure(self) -> bool:
        """Returns True when this failure TRIPPED the breaker
        (closed/half-open → open)."""
        self.failures += 1
        if self.state == "half-open" or (
                self.state == "closed"
                and self.failures >= self.threshold):
            self.state = "open"
            self.opened_at = self._clock()
            self.failures = 0
            self.trips += 1
            return True
        if self.state == "open":
            # failure while already open (e.g. a non-probe path): just
            # restart the cooldown
            self.opened_at = self._clock()
        return False

    def record_success(self) -> None:
        if self.state == "half-open":
            self.state = "closed"
        self.failures = 0

    @property
    def gauge(self) -> float:
        return self.GAUGE[self.state]


@dataclass
class SalvagePlan:
    """What :meth:`EngineSupervisor.contain` hands the runner."""

    #: (request, host-side accepted tokens) for every evacuated slot —
    #: the replay material
    evacuated: list = field(default_factory=list)
    failed_kind: str = ""
    injected: bool = False
    resource: bool = False
    #: the watchdog had tripped on this step before it raised — every
    #: in-engine handle (queued included) was already failed, so the
    #: runner should purge the waiterless queued work too
    suspect: bool = False
    audit: dict = field(default_factory=dict)


class EngineSupervisor:
    """Watchdog + containment + breakers for ONE generation engine.

    Build it over an engine (it registers itself as
    ``engine.supervisor`` so the engine's dispatch boundaries report
    in), hand it to :class:`~.async_runner.AsyncEngineRunner`
    (``supervisor=``) for the production wiring, and ``start()``/
    ``stop()`` it with the runner."""

    def __init__(self, engine: Any, cfg: SupervisorConfig | None = None,
                 *, telemetry: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.cfg = cfg or SupervisorConfig()
        self.telemetry = telemetry if telemetry is not None \
            else getattr(engine, "telemetry", None)
        self._clock = clock
        engine.supervisor = self
        self.verify_breaker = CircuitBreaker(
            "spec_verify", threshold=self.cfg.verify_breaker_threshold,
            probe_after_s=self.cfg.breaker_probe_after_s, clock=clock)
        self.resource_breaker = CircuitBreaker(
            "resource", threshold=self.cfg.resource_breaker_threshold,
            probe_after_s=self.cfg.breaker_probe_after_s, clock=clock)
        # watchdog state: a stack of (kind, started_at, frame_id) —
        # the runner's coarse "step" frame at the bottom, the engine's
        # per-kind dispatch frame nested on top. The INNERMOST frame's
        # deadline governs.
        self._frames: list[tuple[str, float, int]] = []
        self._frame_lock = threading.Lock()
        self._next_frame = 0
        self._tripped_frames: set[int] = set()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._on_suspect: Callable[[EngineSuspect], None] | None = None
        #: suspect flag: set by the watchdog, consumed by the
        #: dispatcher thread (contain()/take_suspect()) after the stuck
        #: step finally returns, so zombie work gets evacuated
        self._suspect_pending = False
        self.last_suspect: EngineSuspect | None = None
        #: last (verify, resource) gauge pair exported — breaker state
        #: is re-exported only on transitions (hot-path economy)
        self._breaker_exported: tuple | None = None
        #: counters (stats(); the telemetry hooks mirror them)
        self.watchdog_trips = 0
        self.containments = 0
        self.released_pins = 0
        self.quarantined: list[int] = []
        #: failed steps since the last successful dispatch — the
        #: engine-unhealthy terminal gate (max_consecutive_failures)
        self.consecutive_failures = 0
        #: nesting of the state-changing calls: only the outermost one
        #: goes into a mesh's operation log
        self._verdict_depth = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "EngineSupervisor":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._watch_loop,
                                        daemon=True,
                                        name="engine-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def set_suspect_callback(
            self, cb: Callable[[EngineSuspect], None] | None) -> None:
        self._on_suspect = cb

    # -- watchdog -------------------------------------------------------

    def begin_dispatch(self, kind: str) -> None:
        with self._frame_lock:
            self._next_frame += 1
            # _clock is a pure time source (time.monotonic or a test
            # stub), never user re-entrant code; reading it inside the
            # frame lock keeps the (kind, t0, id) tuple consistent.
            # jaxlint: disable=race-callback-under-lock
            self._frames.append((kind, self._clock(), self._next_frame))

    def end_dispatch(self, kind: str) -> None:
        with self._frame_lock:
            if self._frames and self._frames[-1][0] == kind:
                _, _, fid = self._frames.pop()
                self._tripped_frames.discard(fid)

    def current_dispatch(self) -> tuple[str, float] | None:
        """(kind, started_at) of the innermost in-progress dispatch —
        what ``AsyncEngineRunner.stop()`` names when the dispatcher
        thread fails to join."""
        with self._frame_lock:
            if not self._frames:
                return None
            kind, t0, _ = self._frames[-1]
            return kind, t0

    def _watch_loop(self) -> None:
        # Stop-aware poll (Event.wait, never time.sleep — the jaxlint
        # blocking-call discipline): each tick compares the innermost
        # dispatch frame against its per-kind deadline.
        while not self._stop_evt.wait(self.cfg.watchdog_poll_s):
            with self._frame_lock:
                if not self._frames:
                    continue
                kind, t0, fid = self._frames[-1]
                if fid in self._tripped_frames:
                    continue
                # pure time source, same as begin_dispatch
                # jaxlint: disable=race-callback-under-lock
                elapsed = self._clock() - t0
                deadline = self.cfg.deadline_for(kind)
                if elapsed <= deadline:
                    continue
                self._tripped_frames.add(fid)
            self._trip(kind, elapsed, deadline)

    def _trip(self, kind: str, elapsed: float, deadline: float) -> None:
        self.watchdog_trips += 1
        self._suspect_pending = True
        exc = EngineSuspect(
            f"engine suspect: {kind} dispatch exceeded its "
            f"{deadline:.1f}s deadline ({elapsed:.1f}s and counting); "
            f"in-flight handles failed, awaiting dispatcher recovery",
            kind=kind, elapsed_s=elapsed, deadline_s=deadline)
        self.last_suspect = exc
        if self.telemetry is not None:
            try:
                self.telemetry.on_watchdog_trip(kind)
            except Exception:
                pass   # observability must not break the watchdog
        cb = self._on_suspect
        if cb is not None:
            try:
                cb(exc)
            except Exception:
                pass   # a broken callback must not kill the watchdog

    @property
    def suspect(self) -> bool:
        return self._suspect_pending

    @property
    def unhealthy(self) -> bool:
        """Too many consecutive failed steps: the failure is not
        transient, and queued work that containment keeps requeuing
        (admit-wave unwinds never touch the replay budget) must stop
        looping — the runner fails everything structured and purges."""
        return self.consecutive_failures \
            >= self.cfg.max_consecutive_failures

    def take_suspect(self) -> bool:
        """Consume the pending-suspect flag (dispatcher thread, after
        the stuck step finally returned)."""
        was = self._suspect_pending
        self._suspect_pending = False
        return was

    # -- dispatch outcome hooks (engine._dispatch_boundary) -------------

    def spec_allowed(self) -> bool:
        """Consulted by the engine before routing a step to the verify
        dispatch: closed → yes; open → no (plain decode serves); open
        past the cooldown → half-open, ONE probe dispatch allowed."""
        allowed = self.verify_breaker.allow()
        self._export_breakers()
        return allowed

    def on_step_ok(self) -> None:
        """A whole engine step completed: the failure streak is over
        (the runner calls this; duck-typed engines without dispatch
        boundaries still reset the unhealthy gate)."""
        self.consecutive_failures = 0

    def on_dispatch_ok(self, kind: str) -> None:
        self.consecutive_failures = 0
        if kind == "verify":
            was_open = self.verify_breaker.state != "closed"
            self.verify_breaker.record_success()
            if was_open:
                self._export_breakers()
        self._maybe_restore_capacity()

    def on_dispatch_error(self, kind: str, exc: BaseException) -> None:
        if kind == "verify":
            self.verify_breaker.record_failure()
            self._export_breakers()
        if is_resource_exhaustion(exc):
            if self.resource_breaker.record_failure():
                self._lower_capacity()
            self._export_breakers()

    # -- degraded modes -------------------------------------------------

    def _lower_capacity(self) -> None:
        """Resource breaker tripped: halve the engine's occupancy cap
        and inform the scheduler's shed loop so backpressure reaches
        the edge (429s) instead of re-OOMing."""
        eng = self.engine
        cap = max(self.cfg.min_slot_cap,
                  getattr(eng, "_slot_cap", eng.num_slots) // 2)
        if hasattr(eng, "set_slot_cap"):
            eng.set_slot_cap(cap)
        sched = getattr(eng, "_sched", None)
        if sched is not None:
            sched.pressure = max(getattr(sched, "pressure", 0), 1)

    def _maybe_restore_capacity(self) -> None:
        """Half-open capacity recovery: once the resource breaker's
        cooldown elapses, each successful dispatch doubles the cap back
        toward ``num_slots``; a fresh exhaustion re-halves and restarts
        the cooldown. Fully restored + probe success → breaker closes
        and the scheduler pressure clears."""
        eng = self.engine
        cap = getattr(eng, "_slot_cap", None)
        if cap is None or self.resource_breaker.state == "closed":
            return
        if not self.resource_breaker.allow():
            return
        if cap < eng.num_slots:
            if hasattr(eng, "set_slot_cap"):
                eng.set_slot_cap(min(eng.num_slots, cap * 2))
            return
        self.resource_breaker.record_success()
        self._export_breakers()
        sched = getattr(eng, "_sched", None)
        if sched is not None:
            sched.pressure = 0

    def _export_breakers(self) -> None:
        if self.telemetry is None:
            return
        # export only on state TRANSITIONS: spec_allowed() runs on the
        # hot dispatch path every step, and two gauge writes per step
        # for state that changes on trip/restore would be pure host tax
        cur = (self.verify_breaker.gauge, self.resource_breaker.gauge)
        if cur == self._breaker_exported:
            return
        self._breaker_exported = cur
        try:
            self.telemetry.breaker_gauge("spec_verify", cur[0])
            self.telemetry.breaker_gauge("resource", cur[1])
        except Exception:
            pass

    # -- containment ----------------------------------------------------

    @contextlib.contextmanager
    def _verdict(self):
        """Around each state-changing call: nested calls (contain's own
        evacuate and audit) are part of the outermost one."""
        self._verdict_depth += 1
        try:
            yield
        finally:
            self._verdict_depth -= 1

    def _log(self, *op) -> None:
        """Rank 0 of a served mesh: the outermost verdict, with what it
        did, into the engine's operation log."""
        log = getattr(self.engine, "_oplog", None)
        if log is not None and self._verdict_depth == 1:
            log.record(op)

    def contain(self, exc: BaseException) -> SalvagePlan:
        """Post-failure containment (DISPATCHER THREAD ONLY): evacuate
        every active/chunking slot, audit + repair the engine's host
        invariants, and — unless the failure provably never touched
        device state (:class:`InjectedFault`) — flush the prefix-cache
        pool. Returns the salvage plan the runner replays from."""
        with self._verdict():
            plan = self._contain(exc)
            self._log("contain", plan.injected, plan.resource,
                      [req.request_id for req, _gen in plan.evacuated])
        return plan

    def _contain(self, exc: BaseException) -> SalvagePlan:
        self.containments += 1
        self.consecutive_failures += 1
        was_suspect = self.take_suspect()
        eng = self.engine
        injected = isinstance(exc, InjectedFault) or bool(
            getattr(exc, "device_state_intact", False))
        plan = SalvagePlan(
            evacuated=self.evacuate(),
            failed_kind=getattr(eng, "_last_failed_kind", "") or "",
            injected=injected,
            resource=is_resource_exhaustion(exc),
            suspect=was_suspect)
        if not injected:
            # Device state is suspect: pool blocks of unknown
            # integrity must never seed a future admission wave.
            # Sharded engines carry one trie per dp shard — flush
            # them all.
            prefixes = getattr(eng, "_prefixes", None)
            if not prefixes:
                p = getattr(eng, "_prefix", None)
                prefixes = [p] if p is not None else []
            for prefix in prefixes:
                if hasattr(prefix, "flush"):
                    prefix.flush()
        plan.audit = self.audit(repair=True)
        return plan

    def evacuate(self) -> list:
        """Pull every active and mid-chunking request out of the engine
        (DISPATCHER THREAD ONLY), releasing slots and prefix pins.
        Returns ``[(request, generated_tokens)]`` — the host-side state
        replay continues from. Chunking requests restart from token
        zero (their partial cache fill is not trusted)."""
        with self._verdict():
            out = self._evacuate()
            self._log("evacuate", [req.request_id for req, _gen in out])
        return out

    def _evacuate(self) -> list:
        eng = self.engine
        paged = bool(getattr(eng, "paged", False))
        out: list = []
        for slot, req in list(getattr(eng, "_active", {}).items()):
            gen = eng._generated.pop(slot, [])
            eng._active.pop(slot, None)
            eng._positions[slot] = eng.max_len
            eng._draft_index.pop(slot, None)
            eng._t_prefill.pop(slot, None)
            self._release_pin(req.request_id)
            if paged:
                # owned blocks back to the pool (BEFORE any prefix
                # flush — a flush must only ever see trie-owned blocks)
                eng._paged_release_slot(slot)
            eng._free.append(slot)
            out.append((req, list(gen)))
        for slot in list(getattr(eng, "_chunking", {})):
            req = eng._chunking.pop(slot)[0]
            eng._positions[slot] = eng.max_len
            if paged:
                eng._paged_release_slot(slot)
            eng._free.append(slot)
            out.append((req, []))
        for slot in list(getattr(eng, "_handoff", {})):
            # prefill-role parked handoffs: the first token was
            # sampled, so the replay continuation carries it
            entry = eng._handoff.pop(slot)
            req, tok = entry[0], entry[1]
            eng._positions[slot] = eng.max_len
            self._release_pin(req.request_id)
            if paged:
                eng._paged_release_slot(slot)
            eng._free.append(slot)
            out.append((req, [int(tok)]))
        return out

    def purge_queued(self) -> list:
        """Drop every request still QUEUED inside the engine
        (DISPATCHER THREAD ONLY) — engine queue, chunk-pending,
        piggyback feed, scheduler tenant queues (via
        ``Scheduler.purge``, which repays the quota ledgers and
        re-exports the gauges) — and abandon their telemetry spans.
        Used after a watchdog suspect event or a terminal unhealthy
        declaration. Returns the dropped requests so the runner can
        fail any handle that is somehow still live."""
        with self._verdict():
            dropped = self._purge_queued()
            self._log("purge_queued", [getattr(r, "request_id", None)
                                       for r in dropped])
        return dropped

    def _purge_queued(self) -> list:
        eng = self.engine
        dropped: list = []
        dropped += list(getattr(eng, "_queue", []))
        dropped += list(getattr(eng, "_chunk_pending", []))
        dropped += [r for r, _t in getattr(eng, "_prefilling", [])]
        if hasattr(eng, "_queue"):
            eng._queue.clear()
        if hasattr(eng, "_chunk_pending"):
            eng._chunk_pending.clear()
        if hasattr(eng, "_prefilling"):
            eng._prefilling.clear()
        sched = getattr(eng, "_sched", None)
        if sched is not None:
            dropped += sched.purge()
        tele = self.telemetry
        if dropped and tele is not None \
                and hasattr(tele, "abandon_in_flight"):
            try:
                # nothing legitimate is in flight after an evacuate +
                # purge; close the orphaned spans so the next
                # post-mortem doesn't list dead requests as live
                tele.abandon_in_flight()
            except Exception:
                pass
        return dropped

    def _release_pin(self, request_id: int) -> None:
        eng = self.engine
        pins = getattr(eng, "_prefix_pins", None)
        prefix = getattr(eng, "_prefix", None)
        if pins is None:
            return
        m = pins.pop(request_id, None)
        if m is not None and prefix is not None:
            prefix.release(m)

    # -- invariant audit ------------------------------------------------

    def audit(self, repair: bool = True) -> dict:
        """Check (and optionally repair) the engine's host invariants
        (DISPATCHER THREAD ONLY). Returns a findings dict; with
        ``repair=True`` it also:

        * deduplicates the free list and drops free-list entries that
          are simultaneously active/chunking (active wins — freeing a
          live slot would let two requests share one KV timeline);
        * QUARANTINES slots tracked by no table at all (a slot lost by
          a mid-update crash is poisoned: nothing is known about its
          cache columns, so it never serves again this process);
        * drops ``_generated``/draft-index/prefill-timing orphans;
        * releases prefix-cache pins whose request is no longer active
          (the leak that would pin pool blocks forever);
        * recomputes the scheduler's per-tenant queued-token ledgers
          from the actual queues."""
        with self._verdict():
            findings = self._audit(repair)
            self._log("audit", repair, findings)
        return findings

    def _audit(self, repair: bool) -> dict:
        eng = self.engine
        findings: dict[str, Any] = {}
        active = set(getattr(eng, "_active", {}))
        chunking = set(getattr(eng, "_chunking", {}))
        handoff = set(getattr(eng, "_handoff", {}))
        free = list(getattr(eng, "_free", []))
        quarantined = set(self.quarantined)

        dup_free = sorted({s for s in free if free.count(s) > 1})
        overlap = sorted((set(free) & active) | (set(free) & chunking)
                         | (set(free) & handoff))
        known = set(free) | active | chunking | handoff | quarantined
        lost = sorted(set(range(eng.num_slots)) - known)
        gen_orphans = sorted(set(getattr(eng, "_generated", {})) - active)
        active_rids = {r.request_id
                       for r in getattr(eng, "_active", {}).values()}
        # handoff-parked requests still BORROW their matched trie
        # blocks until export — releasing their pins here would let
        # the trie evict KV a parked table references
        active_rids |= {h[0].request_id
                        for h in getattr(eng, "_handoff", {}).values()}
        pin_leaks = sorted(rid for rid in getattr(eng, "_prefix_pins", {})
                           if rid not in active_rids)
        if dup_free:
            findings["duplicate_free_slots"] = dup_free
        if overlap:
            findings["free_while_active"] = overlap
        if lost:
            findings["quarantined_slots"] = lost
        if gen_orphans:
            findings["generated_orphans"] = gen_orphans
        if pin_leaks:
            findings["leaked_pins"] = pin_leaks

        # -- paged KV: block-table exclusivity + allocator agreement --
        # (the paged mirror of the free-list repair above: a block
        # owned by two slots, or owned AND free, would alias two KV
        # timelines — docs/ENGINE_PREFIX_CACHE.md#paged-kv)
        paged = bool(getattr(eng, "paged", False))
        block_conflicts: set[int] = set()
        owned_blocks: set[int] = set()
        if paged:
            pool = eng._pool
            prefixes = getattr(eng, "_prefixes", None)
            if prefixes is None:
                p = getattr(eng, "_prefix", None)
                prefixes = [p] if p is not None else []
            trie_blocks = {n.block_id for p in prefixes
                           for n in p._nodes}
            owned_blocks |= trie_blocks
            owner_of: dict[int, int] = {}
            for slot in range(eng.num_slots):
                tbl = eng._tables[slot]
                of = eng._owned_from[slot]
                if tbl and slot not in active and slot not in chunking \
                        and slot not in handoff:
                    # a table on a slot no request tracks is an orphan:
                    # its blocks are unaccounted-for
                    findings.setdefault("block_table_orphans",
                                        []).append(slot)
                    block_conflicts.add(slot)
                    continue
                for i, bid in enumerate(tbl):
                    if i < of:
                        # borrowed entries must be trie blocks
                        if bid not in trie_blocks:
                            block_conflicts.add(slot)
                        continue
                    if bid in owner_of or bid in trie_blocks \
                            or pool.is_free(bid):
                        block_conflicts.add(slot)
                        if bid in owner_of:
                            block_conflicts.add(owner_of[bid])
                    owner_of[bid] = slot
            if block_conflicts:
                findings["block_table_overlap"] = sorted(
                    block_conflicts)
            owned_blocks |= {b for b, s in owner_of.items()
                             if s not in block_conflicts}

        sched = getattr(eng, "_sched", None)
        sched_drift: dict[str, tuple[int, int]] = {}
        if sched is not None and repair:
            # Scheduler owns its ledger math: recount repairs drifted
            # per-tenant queued-token totals and re-exports the gauges
            sched_drift = sched.recount_queued_tokens()
            if sched_drift:
                findings["sched_queued_tokens_drift"] = {
                    t: {"recorded": a, "actual": b}
                    for t, (a, b) in sched_drift.items()}

        if repair:
            if dup_free or overlap:
                bad = set(overlap)
                seen: set[int] = set()
                eng._free = [s for s in free
                             if s not in bad
                             and not (s in seen or seen.add(s))]
            for slot in lost:
                self.quarantined.append(slot)
            for slot in gen_orphans:
                eng._generated.pop(slot, None)
                eng._draft_index.pop(slot, None)
                eng._t_prefill.pop(slot, None)
            for rid in pin_leaks:
                self._release_pin(rid)
                self.released_pins += 1
            if paged:
                for slot in sorted(block_conflicts):
                    # irreconcilable ownership: nothing about the
                    # slot's blocks can be trusted — drop its request
                    # (the journal/replay plane re-serves it) and
                    # quarantine the slot; the free-list rebuild below
                    # reclaims whatever nobody legitimately owns
                    eng._tables[slot] = []
                    eng._owned_from[slot] = 0
                    req = eng._active.pop(slot, None)
                    if req is None:
                        ch = eng._chunking.pop(slot, None)
                        req = ch[0] if ch else None
                    if req is None:
                        h = getattr(eng, "_handoff", {}).pop(slot,
                                                             None)
                        req = h[0] if h else None
                    if req is not None:
                        self._release_pin(req.request_id)
                    eng._generated.pop(slot, None)
                    eng._draft_index.pop(slot, None)
                    eng._positions[slot] = eng.max_len
                    eng._free = [s for s in eng._free if s != slot]
                    if slot not in self.quarantined:
                        self.quarantined.append(slot)
                drift = eng._pool.rebuild_free_list(owned_blocks)
                if drift:
                    findings["block_freelist_drift"] = sorted(drift)
            if self.telemetry is not None:
                try:
                    if pin_leaks:
                        self.telemetry.on_released_pins(len(pin_leaks))
                    self.telemetry.gauge_quarantined(
                        len(self.quarantined))
                except Exception:
                    pass
            repaired = getattr(eng, "on_repaired", None)
            if repaired is not None:
                # the host state the engine's decode graphs read is
                # consistent again: they may be captured anew
                repaired()
        return findings

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        return {
            "watchdog_trips": self.watchdog_trips,
            "containments": self.containments,
            "consecutive_failures": self.consecutive_failures,
            "released_pins": self.released_pins,
            "quarantined_slots": list(self.quarantined),
            "breakers": {
                b.name: {"state": b.state, "trips": b.trips}
                for b in (self.verify_breaker, self.resource_breaker)
            },
        }


def _no_clock() -> float:
    raise AssertionError("a follower's supervisor reads no clock: its "
                         "verdicts are rank 0's")


class FollowerSupervisor(EngineSupervisor):
    """The supervisor of a rank that follows rank 0's operation log
    (``engine/mesh_runner.py``). It applies rank 0's verdicts to this
    rank's engine as the log names them (:meth:`contain` with rank 0's
    classification of the failure, :meth:`evacuate`,
    :meth:`purge_queued`, :meth:`audit`) and decides nothing itself: it
    reads no clock, runs no watchdog thread, and its breakers stay
    closed. Rank 0's ``spec_verify`` verdict reaches the engine through
    its broadcast decision, a lowered slot cap through the log."""

    def __init__(self, engine: Any, cfg: SupervisorConfig | None = None,
                 *, telemetry: Any = None):
        super().__init__(engine, cfg, telemetry=telemetry, clock=_no_clock)

    def start(self) -> "FollowerSupervisor":
        return self

    def stop(self) -> None:
        pass

    def begin_dispatch(self, kind: str) -> None:
        pass

    def end_dispatch(self, kind: str) -> None:
        pass

    def spec_allowed(self) -> bool:
        return True               # rank 0's verdict is the one broadcast

    def on_dispatch_ok(self, kind: str) -> None:
        self.consecutive_failures = 0

    def on_dispatch_error(self, kind: str, exc: BaseException) -> None:
        pass


def resolve_supervisor(supervisor, engine) -> EngineSupervisor | None:
    """Runner-side ``supervisor=`` argument semantics: None/False
    disables, True builds one with defaults, a
    :class:`SupervisorConfig` builds from it, an
    :class:`EngineSupervisor` instance is used as-is (it must already
    wrap the same engine).

    Every ``AsyncEngineRunner`` resolves its supervisor here as it is
    built. Over an engine on a mesh of several ranks only rank 0 runs a
    runner, and only with the engine's operation log attached
    (``engine/mesh_runner.py``'s ``MeshEngineRunner``): a runner alone
    would step rank 0's engine while the other ranks wait for no step."""
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.size > 1 \
            and getattr(engine, "_oplog", None) is None:
        raise ValueError(
            f"an AsyncEngineRunner over an engine on a mesh of {mesh.size} "
            f"ranks serves on rank 0 as engine.mesh_runner.MeshEngineRunner "
            f"(CUDASummarizer.summarize_async), while every other rank "
            f"follows rank 0's log with mesh_runner.follow(engine) "
            f"(CUDASummarizer.follow())")
    if supervisor is None or supervisor is False:
        return None
    if supervisor is True:
        return EngineSupervisor(engine)
    if isinstance(supervisor, SupervisorConfig):
        return EngineSupervisor(engine, supervisor)
    if isinstance(supervisor, EngineSupervisor):
        if supervisor.engine is not engine:
            raise ValueError(
                "supervisor wraps a different engine than the runner's")
        return supervisor
    raise ValueError(
        f"supervisor must be None/bool, SupervisorConfig or "
        f"EngineSupervisor, got {type(supervisor).__name__}")
