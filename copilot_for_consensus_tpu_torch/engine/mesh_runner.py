"""The async runner over a dp×tp mesh: rank 0 serves, every other rank
follows rank 0's operation log.

Each rank of a mesh is its own process, and the engine's collectives hold
the ranks in lockstep: every rank must make the same engine calls with the
same arguments in the same order. The async front end
(``engine/async_runner.py``) takes work one request at a time on a
dispatcher thread, so its calls are decided by when requests arrive, and
its supervisor (``engine/supervisor.py``) decides by clocks. Rank 0 alone
therefore runs the ``AsyncEngineRunner`` and its supervisor
(:class:`MeshEngineRunner`), and records in order every call that changes
the engine's host state:

* each submit the engine accepted, with its arguments as admitted and the
  request id it returned (the runner's shed check on the caller's thread
  and the engine's own in ``submit`` run on rank 0 alone: a shed request
  never reaches the log);
* each step, and after it the step's outcome (whether it raised, and the
  ids it completed);
* each supervisor verdict: ``contain`` with rank 0's classification of
  the failure (injected, resource exhaustion), ``evacuate``,
  ``purge_queued`` and ``audit``, each with what it did; the replays the
  runner resubmits are submits like any other;
* a slot cap the resource breaker lowered or raised, applied on every
  rank, rank 0 included, as the next step begins;
* the end: a stop, and whether rank 0's summarizer closed.

Before each step rank 0 publishes what it recorded since the last one.
Every other rank runs no runner and no watchdog (:func:`follow`): it
applies each batch to its own engine in order, through a
``FollowerSupervisor`` that decides nothing and reads no clock, checks
that each request id, each step's outcome and each verdict's result equals
rank 0's (a mismatch raises :class:`MeshDivergence` rather than hanging in
the next collective), and steps with rank 0. The decisions inside a step
that read a clock were rank 0's already (the engine's broadcast
decisions). The fault plane is deterministic per kind and occurrence, and
every rank passes the same dispatch boundaries in the same order, so one
``FaultPlan`` given to every rank fires the same faults everywhere (a
``mode="hang"`` fault hangs every rank alike); only rank 0 tokenizes, so
the ``tokenize`` point is rank 0's. The request journal stays on rank 0:
its checkpoints at stop, its abandons and the replays' re-keys are rank 0's
runner's, and the other ranks hold no store.

**The channel** is the process group's own key-value store
(``parallel.collectives.ControlChannel`` under the prefix ``ctl/``), not a
broadcast. Rank 0's publish is one ``set`` that never waits for the other
ranks; a waiting rank reads whether the batch is there, backing off from
0.2 ms to 10 ms between reads, so it sees a batch that follows a step
within a fraction of a millisecond. So no collective of any group is open
while the runner is idle — an idle wait of any length outlasts no
timeout, and NCCL takes no part in it — and there is no control group
whose creation or timeout would have to agree with rank 0's idle
periods. The store also
tells a following rank when rank 0 is gone: a ``tcp://`` join's store is
served by rank 0, so its connection breaks, and rank 0 counts a heartbeat
up every second from the moment its engine is built, so a store served
elsewhere shows a heartbeat that stands still; either raises
``ChannelLost`` within three times the groups' timeout (at least 30 s).

**Limits.** A real failure on one rank cannot be contained in lockstep.
When a rank dies, or stops answering, rank 0's next collective fails at
once (a closed connection) or after the groups' timeout; rank 0 then fails
every outstanding handle with a structured ``EngineFailed``
(``reason="mesh-failed"``, naming the timeout and the error), refuses new
submits with it, keeps its journal rows for a warm restart, and tells the
ranks still alive, which raise ``MeshFailed`` and exit non-zero (a rank
stuck in a collective with the dead one fails there first). A failure
raised on rank 0 alone that the collectives do not see (a real device
fault) is contained on rank 0, and the other ranks raise
``MeshDivergence`` at its outcome; rank 0's next collective then fails as
above. Under NCCL, its watchdog may end a rank's process at the timeout
before the engine sees the error.
"""

from __future__ import annotations

import threading
import time

from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
)
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    EngineFailed,
    FollowerSupervisor,
)
from copilot_for_consensus_tpu_torch.parallel.collectives import (
    ControlChannel,
    is_collective_failure,
)


class MeshDivergence(RuntimeError):
    """A following rank's engine did not do what rank 0's did: a request
    id, a step's outcome or a verdict's result differs."""


class MeshFailed(RuntimeError):
    """Rank 0 reported that the mesh lost a rank; this rank stops too."""


class LeaderVerdict(RuntimeError):
    """Rank 0's classification of a failed step, for a following rank's
    ``contain``: whether device state is intact (an injected fault) and
    whether the failure was resource exhaustion."""

    def __init__(self, injected: bool, resource: bool):
        super().__init__("rank 0's containment verdict")
        self.device_state_intact = bool(injected)
        self.resource_exhausted = bool(resource)


def _multi_rank(engine) -> bool:
    mesh = getattr(engine, "mesh", None)
    return mesh is not None and mesh.size > 1


def _open_channel(engine) -> ControlChannel:
    """The channel of the engine's next serving session: rank 0's runner
    and each following rank open one session each, in the same order. A
    following rank gives rank 0 up after three groups' timeouts of a
    still heartbeat (at least 30 s)."""
    mesh = engine.mesh
    engine._log_sessions += 1
    return ControlChannel(
        mesh.store, f"{engine._log_serial}.{engine._log_sessions}",
        readers=mesh.size - 1,
        dead_after_s=max(30.0, 3.0 * mesh.timeout_s))


def _completion_row(c) -> list:
    return [c.request_id, list(c.tokens), c.finish_reason, c.prompt_len]


class OpLog:
    """Rank 0's recorder, attached to the engine as ``engine._oplog``
    (the engine calls :meth:`on_submit`, :meth:`on_slot_cap`,
    :meth:`before_step` and :meth:`after_step`; the supervisor calls
    :meth:`record`). ``keep`` keeps every batch and every step's
    completions (tests, the card's smoke run)."""

    def __init__(self, engine, channel: ControlChannel, *,
                 keep: bool = False):
        self.engine = engine
        self.channel = channel
        self._ops: list = []
        self._lock = threading.Lock()
        self._cap: int | None = None
        self._attached = False
        self._t_step = 0.0
        #: the structured failure every handle gets once the mesh lost a
        #: rank (None while it serves)
        self.broken: EngineFailed | None = None
        self.batches: list | None = [] if keep else None
        self.completions: list | None = [] if keep else None
        self.steps = 0
        self.ops = 0
        self.step_s = 0.0

    # -- what the engine and the supervisor report --------------------

    def record(self, op: tuple) -> None:
        with self._lock:
            self._ops.append(op)

    def on_submit(self, rid: int, prompt, max_new_tokens: int,
                  kw: dict) -> None:
        self.record(("submit", rid, list(prompt), max_new_tokens, kw))

    def on_slot_cap(self, cap: int) -> None:
        with self._lock:
            self._cap = cap

    def before_step(self) -> None:
        if self.broken is not None:
            raise self.broken
        with self._lock:
            ops, self._ops = self._ops, []
            cap, self._cap = self._cap, None
        if cap is not None:
            # rank 0 applies its own verdict where the others do: here
            eng = self.engine
            eng._slot_cap = cap
            sched = getattr(eng, "_sched", None)
            ops.append(("slot_cap", cap, getattr(sched, "pressure", None)))
        ops.append(("step",))
        self._publish(ops)
        self._t_step = time.perf_counter()

    def after_step(self, comps, exc: BaseException | None) -> None:
        self.step_s += time.perf_counter() - self._t_step
        self.steps += 1
        if exc is not None and is_collective_failure(exc):
            mesh = self.engine.mesh
            self.broken = EngineFailed(
                f"the mesh of {mesh.size} ranks lost a rank (a peer died "
                f"or did not answer within the groups' {mesh.timeout_s:.0f}"
                f" s timeout): {type(exc).__name__}: {exc}",
                reason="mesh-failed")
            self._publish([("stop", str(self.broken), True)], quiet=True)
            raise self.broken from exc
        self.record(("outcome", exc is None,
                     None if comps is None
                     else [c.request_id for c in comps]))
        if self.completions is not None and comps:
            self.completions.extend(_completion_row(c) for c in comps)

    # -- publishing -----------------------------------------------------

    def _publish(self, ops: list, *, quiet: bool = False) -> None:
        if not self._attached:
            self._attached = True
            ops.insert(0, ("attach",
                           self.engine.supervisor is not None))
        self.ops += len(ops)
        if self.batches is not None:
            self.batches.append(ops)
        try:
            self.channel.publish(ops)
        except Exception as exc:
            if quiet:
                return
            self.broken = EngineFailed(
                f"rank 0 could not publish its operation log to the mesh's "
                f"store: {type(exc).__name__}: {exc}", reason="mesh-failed")
            raise self.broken from exc

    def stop(self, *, final: bool) -> None:
        """The last batch: what was recorded since the last step, then the
        stop (``final``: rank 0's summarizer closed)."""
        if self.broken is not None:
            return
        with self._lock:
            ops, self._ops = self._ops, []
        ops.append(("stop", "", final))
        self._publish(ops, quiet=True)

    def stats(self) -> dict:
        return {"steps": self.steps, "ops": self.ops,
                "step_s": self.step_s, "publish_s": self.channel.io_s,
                "bytes": self.channel.bytes,
                "broken": str(self.broken) if self.broken else ""}


class MeshEngineRunner(AsyncEngineRunner):
    """The ``AsyncEngineRunner`` of rank 0 of a mesh of several ranks: the
    runner and its supervisor as they are, over an engine whose operation
    log (:class:`OpLog`) publishes every call to the other ranks, which
    :func:`follow` it. ``keep_log`` keeps the log and the completions
    (``self.oplog``). Once the mesh lost a rank, every outstanding handle
    fails with the log's structured ``EngineFailed``, the dispatcher ends
    (a containment it still runs touches rank 0's host state alone) and
    ``submit`` raises it."""

    def __init__(self, engine, *, error_reporter=None, supervisor=None,
                 keep_log: bool = False):
        if not _multi_rank(engine):
            raise ValueError("MeshEngineRunner serves an engine on a mesh "
                             "of several ranks; use AsyncEngineRunner")
        if not engine.mesh.is_first:
            raise ValueError(
                "MeshEngineRunner runs on rank 0; every other rank calls "
                "mesh_runner.follow(engine) (CUDASummarizer.follow())")
        if engine._oplog is not None:
            raise RuntimeError("the engine is already served by a runner")
        self.oplog = OpLog(engine, _open_channel(engine), keep=keep_log)
        engine._oplog = self.oplog
        try:
            super().__init__(engine, error_reporter=error_reporter,
                             supervisor=supervisor)
        except BaseException:
            engine._oplog = None
            self.oplog.stop(final=False)
            raise

    def submit(self, *a, **kw):
        if self.oplog.broken is not None:
            raise self.oplog.broken
        return super().submit(*a, **kw)

    def _report_engine_error(self, exc: BaseException) -> None:
        super()._report_engine_error(exc)
        broken = self.oplog.broken
        if broken is not None:
            # lockstep cannot go on: every handle gets the structured
            # failure now, and the dispatcher ends at its next turn
            # (journal rows stay for a warm restart)
            self._fail_outstanding(broken)
            with self._work:
                self._stop = True
            self._stop_evt.set()         # a drain() in progress ends now

    def stop(self, timeout: float = 30.0, *, final: bool = False) -> bool:
        """Stop as ``AsyncEngineRunner.stop`` does, then publish the stop
        (``final``: the serving front end closes for good) and detach the
        log: the engine can serve in lockstep again."""
        joined = super().stop(timeout)
        self.oplog.stop(final=final)
        if self.engine._oplog is self.oplog:
            self.engine._oplog = None
        return joined


def release_followers(engine, *, final: bool) -> None:
    """Rank 0 with no runner: a session with nothing but its stop, so that
    the ranks waiting in :func:`follow` return."""
    OpLog(engine, _open_channel(engine)).stop(final=final)


class _Applier:
    """Applies rank 0's batches to one engine, checking each id and each
    result against rank 0's (a following rank, or an un-meshed engine
    replaying a kept log)."""

    def __init__(self, engine, *, keep: bool):
        self.engine = engine
        self._outcome: tuple | None = None
        self.completions: list | None = [] if keep else None
        self.counts = {"batches": 0, "ops": 0, "submits": 0, "steps": 0,
                       "completed": 0, "contained": 0, "step_s": 0.0,
                       "closed": False}

    def _diverged(self, what: str, mine, rank0) -> None:
        raise MeshDivergence(
            f"{what} differs from rank 0's after {self.counts['steps']} "
            f"steps: here {mine!r}, rank 0 {rank0!r}")

    def apply(self, batch: list) -> bool:
        """Apply one batch; True once it held the stop."""
        eng = self.engine
        self.counts["batches"] += 1
        self.counts["ops"] += len(batch)
        for op in batch:
            kind = op[0]
            sup = eng.supervisor
            if kind == "attach":
                if not op[1]:
                    eng.supervisor = None
                elif not isinstance(sup, FollowerSupervisor):
                    FollowerSupervisor(eng)
            elif kind == "submit":
                _, rid, prompt, mnt, kw = op
                got = eng.submit(prompt, mnt, **kw)
                self.counts["submits"] += 1
                if got != rid:
                    self._diverged("a request id", got, rid)
            elif kind == "outcome":
                if self._outcome != (op[1], op[2]):
                    self._diverged("a step's outcome", self._outcome,
                                   (op[1], op[2]))
            elif kind == "contain":
                plan = sup.contain(LeaderVerdict(op[1], op[2]))
                self.counts["contained"] += 1
                got = [req.request_id for req, _gen in plan.evacuated]
                if got != op[3]:
                    self._diverged("a containment's evacuated ids", got,
                                   op[3])
            elif kind == "evacuate":
                got = [req.request_id for req, _gen in sup.evacuate()]
                if got != op[1]:
                    self._diverged("an evacuation", got, op[1])
            elif kind == "purge_queued":
                got = [getattr(r, "request_id", None)
                       for r in sup.purge_queued()]
                if got != op[1]:
                    self._diverged("a purge", got, op[1])
            elif kind == "audit":
                got = sup.audit(repair=op[1])
                if got != op[2]:
                    self._diverged("an audit's findings", got, op[2])
            elif kind == "slot_cap":
                eng._slot_cap = op[1]
                sched = getattr(eng, "_sched", None)
                if sched is not None and op[2] is not None:
                    sched.pressure = op[2]
            elif kind == "step":
                self._step()
            elif kind == "stop":
                if op[1]:
                    raise MeshFailed(f"rank 0 stopped the mesh: {op[1]}")
                self.counts["closed"] = bool(op[2])
                return True
            else:
                raise MeshDivergence(f"unknown operation {kind!r}")
        return False

    def _step(self) -> None:
        t0 = time.perf_counter()
        self.counts["steps"] += 1
        try:
            comps = self.engine.step()
        except Exception as exc:
            if is_collective_failure(exc):
                raise
            self._outcome = (False, None)
            return
        finally:
            self.counts["step_s"] += time.perf_counter() - t0
        self._outcome = (True, [c.request_id for c in comps])
        self.counts["completed"] += len(comps)
        if self.completions is not None:
            self.completions.extend(_completion_row(c) for c in comps)


def follow(engine, *, keep: bool = False) -> dict:
    """Serve rank 0's traffic on this rank (any rank but 0 of a mesh of
    several ranks): apply rank 0's operation log to ``engine`` and step
    with rank 0, until rank 0's runner stops. Returns this rank's counts —
    batches, operations, submits, steps, completed requests, containments,
    ``closed`` (rank 0's front end closed for good), the seconds spent
    stepping, waiting for rank 0 and reading the channel — and, with
    ``keep``, ``completions`` (each step's ``[id, tokens, finish_reason,
    prompt_len]``). Raises ``MeshDivergence``, ``MeshFailed`` or
    ``ChannelLost``; one of them means the mesh cannot go on."""
    if not _multi_rank(engine):
        raise ValueError("follow() serves an engine on a mesh of several "
                         "ranks")
    if engine.mesh.is_first:
        raise ValueError("rank 0 serves: it runs MeshEngineRunner "
                         "(CUDASummarizer.summarize_async), not follow()")
    channel = _open_channel(engine)
    applier = _Applier(engine, keep=keep)
    t0 = time.perf_counter()
    engine._follows_log = True
    try:
        while not applier.apply(channel.receive()):
            pass
    finally:
        engine._follows_log = False
    out = dict(applier.counts, wall_s=time.perf_counter() - t0,
               wait_s=channel.wait_s, channel_s=channel.io_s,
               bytes=channel.bytes)
    if keep:
        out["completions"] = applier.completions
    return out


def replay(engine, batches: list) -> list:
    """Apply a log rank 0 kept (``MeshEngineRunner(keep_log=True)``) to an
    un-meshed ``engine`` built alike (the same fault plan included), with
    the same checks as :func:`follow`. Returns each step's completions as
    :func:`follow` keeps them. Decisions that read a clock are this
    engine's own here: replay traffic that has none (no admission hold,
    deadline or scheduler), or whose outcome they do not change."""
    applier = _Applier(engine, keep=True)
    engine._follows_log = True
    try:
        for batch in batches:
            if applier.apply(batch):
                break
    finally:
        engine._follows_log = False
    return applier.completions
