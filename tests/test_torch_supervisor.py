# The port's fault plane (engine/faults.py), supervisor
# (engine/supervisor.py) and async runner (engine/async_runner.py) under
# the host-level cases of tests/test_engine_chaos.py: the fault plane and
# circuit breaker units and every StubEngine case — watchdog, request
# replay, purge, audit, resolve_supervisor, breakers — with the stub (plain
# Python) copied here. The scheduler's cases
# (test_purge_queued_repays_scheduler_ledgers and the scheduler half of
# test_resource_breaker_lowers_cap_and_informs_scheduler) run on the
# port's engine in tests/test_torch_scheduler.py, and
# test_deadline_completion_surfaces_as_structured_failure in
# tests/test_torch_deadlines.py. The two prefix-cache cases run against the
# port's shared-pool PrefixCache, which publishes by adopting a slot's
# blocks instead of copying a contiguous cache.
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
    Handle,
)
from copilot_for_consensus_tpu_torch.engine.faults import (
    PERSISTENT,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    resolve_faults,
)
from copilot_for_consensus_tpu_torch.engine.generation import Completion
from copilot_for_consensus_tpu_torch.engine.kv_pool import BlockPool
from copilot_for_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    CircuitBreaker,
    EngineFailed,
    EngineSupervisor,
    EngineSuspect,
    SupervisorConfig,
    is_resource_exhaustion,
    resolve_supervisor,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config


# ---------------------------------------------------------------------------
# fault plane (host units)
# ---------------------------------------------------------------------------


def test_fault_spec_occurrence_windows():
    s = FaultSpec(kind="decode", at=3, count=2)
    assert [s.fires_at(i) for i in range(1, 7)] == [
        False, False, True, True, False, False]
    p = FaultSpec(kind="decode", at=2, count=PERSISTENT)
    assert not p.fires_at(1) and p.fires_at(2) and p.fires_at(999)


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="mode"):
        FaultSpec(kind="decode", mode="explode")
    with pytest.raises(ValueError, match="at"):
        FaultSpec(kind="decode", at=0)
    with pytest.raises(ValueError, match="count"):
        FaultSpec(kind="decode", count=0)
    with pytest.raises(ValueError, match="hang_s"):
        FaultSpec(kind="decode", mode="hang")
    with pytest.raises(ValueError, match="rate"):
        FaultSpec(kind="decode", rate=1.5)


def test_injector_transient_vs_persistent_and_wildcard():
    inj = FaultInjector(FaultPlan(specs=[
        FaultSpec(kind="decode", at=2, count=1),
        FaultSpec(kind="*", at=5, count=PERSISTENT)]))
    inj.check("decode")                      # occurrence 1: clean
    with pytest.raises(InjectedFault) as ei:
        inj.check("decode")                  # occurrence 2: transient
    assert ei.value.kind == "decode" and ei.value.occurrence == 2
    assert ei.value.device_state_intact
    inj.check("decode")                      # 3: clean again
    inj.check("decode")                      # 4
    for _ in range(3):                       # 5+: wildcard persistent
        with pytest.raises(InjectedFault):
            inj.check("decode")
    # a different kind has its own counter; wildcard applies there too
    for _ in range(4):
        inj.check("prefill")
    with pytest.raises(InjectedFault):
        inj.check("prefill")
    # clear() ends the persistent fault (half-open probes rely on it)
    inj.clear()
    inj.check("decode")
    assert inj.stats()["fired"] == 5


def test_injector_seeded_rate_is_deterministic():
    plan = {"seed": 42, "specs": [
        {"kind": "decode", "rate": 0.5, "mode": "error"}]}

    def firing_pattern():
        inj = FaultInjector(FaultPlan.from_dict(plan))
        out = []
        for _ in range(32):
            try:
                inj.check("decode")
                out.append(False)
            except InjectedFault:
                out.append(True)
        return out

    a, b = firing_pattern(), firing_pattern()
    assert a == b                    # same seed → same fault sequence
    assert any(a) and not all(a)     # actually probabilistic


def test_fault_plan_dict_roundtrip():
    plan = FaultPlan(seed=3, specs=[
        FaultSpec(kind="verify", at=1, count=3),
        FaultSpec(kind="decode", mode="hang", hang_s=0.5)])
    again = FaultPlan.from_dict(plan.to_dict())
    assert again == plan


def test_injected_hang_is_stop_aware():
    inj = FaultInjector(FaultPlan(specs=[
        FaultSpec(kind="decode", mode="hang", hang_s=30.0)]))
    t0 = time.monotonic()
    releaser = threading.Timer(0.1, inj.release_hangs)
    releaser.start()
    try:
        with pytest.raises(InjectedFault) as ei:
            inj.check("decode")
    finally:
        releaser.cancel()
    assert time.monotonic() - t0 < 10.0      # released, not waited out
    assert ei.value.mode == "hang"


def test_resolve_faults_semantics():
    assert resolve_faults(None) is None
    assert resolve_faults(False) is None
    inj = FaultInjector(FaultPlan())
    assert resolve_faults(inj) is inj
    assert isinstance(resolve_faults(FaultPlan()), FaultInjector)
    assert isinstance(
        resolve_faults([FaultSpec(kind="decode")]), FaultInjector)
    with pytest.raises(ValueError):
        resolve_faults("chaos")


# ---------------------------------------------------------------------------
# circuit breaker (host units)
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_lifecycle_closed_open_halfopen_closed():
    clk = _Clock()
    b = CircuitBreaker("spec_verify", threshold=3, probe_after_s=10.0,
                       clock=clk)
    assert b.allow() and b.gauge == 0.0
    assert not b.record_failure()
    assert not b.record_failure()
    assert b.record_failure()            # 3rd consecutive → trips
    assert b.state == "open" and b.gauge == 1.0 and b.trips == 1
    assert not b.allow()                 # cooldown not elapsed
    clk.t = 10.0
    assert b.allow() and b.state == "half-open" and b.gauge == 0.5
    b.record_success()                   # probe succeeded
    assert b.state == "closed" and b.gauge == 0.0


def test_breaker_probe_failure_reopens():
    clk = _Clock()
    b = CircuitBreaker("spec_verify", threshold=1, probe_after_s=5.0,
                       clock=clk)
    assert b.record_failure()            # threshold 1: first trip
    clk.t = 5.0
    assert b.allow() and b.state == "half-open"
    assert b.record_failure()            # probe failed → re-open
    assert b.state == "open" and b.trips == 2
    assert not b.allow()                 # cooldown restarted at t=5
    clk.t = 9.9
    assert not b.allow()
    clk.t = 10.0
    assert b.allow()


def test_breaker_success_resets_consecutive_count():
    b = CircuitBreaker("x", threshold=2, probe_after_s=1.0)
    b.record_failure()
    b.record_success()
    b.record_failure()                   # not consecutive: no trip
    assert b.state == "closed"


def test_resource_exhaustion_classifier():
    assert is_resource_exhaustion(RuntimeError("RESOURCE_EXHAUSTED: "
                                               "while allocating"))
    assert is_resource_exhaustion(MemoryError())
    assert not is_resource_exhaustion(RuntimeError("shape mismatch"))
    assert not is_resource_exhaustion(InjectedFault("x"))


# ---------------------------------------------------------------------------
# stub engine: the host-level harness for runner/supervisor units
# ---------------------------------------------------------------------------


class StubEngine:
    """Scriptable engine stand-in with the host tables the supervisor
    audits. ``script`` entries per step(): "ok" (complete everything
    queued), "fail" (activate queued with ``fail_gen`` tokens each,
    then raise), "block" (wait on self.release, then return [])."""

    def __init__(self, script=(), fail_gen=2, fail_exc=None):
        self.script = list(script)
        self.fail_gen = fail_gen
        self.fail_exc = fail_exc or RuntimeError("stub dispatch died")
        self.release = threading.Event()
        self.num_slots = 4
        self.max_len = 64
        self.telemetry = None
        self.faults = None
        self.supervisor = None
        self._last_failed_kind = "decode"
        self._queue = []
        self._active = {}
        self._generated = {}
        self._draft_index = {}
        self._t_prefill = {}
        self._prefix = None
        self._prefix_pins = {}
        self._chunking = {}
        self._chunk_pending = []
        self._prefilling = []
        self._sched = None
        self._free = list(range(self.num_slots))
        self._positions = np.full(self.num_slots, self.max_len,
                                  dtype=np.int32)
        self._rid = 0
        self.submits = []

    def submit(self, prompt, max_new_tokens, **kw):
        self._rid += 1
        req = SimpleNamespace(
            request_id=self._rid, prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            cache_eligible_tokens=kw.get("cache_eligible_tokens"),
            correlation_id=kw.get("correlation_id", ""),
            tenant=kw.get("tenant", ""), priority=kw.get("priority", ""),
            deadline_at=float("inf"))
        self._queue.append(req)
        self.submits.append((list(prompt), max_new_tokens, dict(kw)))
        return self._rid

    def _complete(self, req):
        # deterministic: token i is sum(first-3 prompt tokens) + i —
        # enough structure for the stitching assertions
        base = sum(req.prompt[:3])
        toks = [base + i for i in range(req.max_new_tokens)]
        return Completion(request_id=req.request_id,
                          prompt_len=len(req.prompt), tokens=toks,
                          finish_reason="length")

    def step(self):
        action = self.script.pop(0) if self.script else "ok"
        if action == "block":
            self.release.wait(15.0)
            return []
        if action == "fail_queued":
            # admission-wave style failure: the lossless unwind left
            # the requests QUEUED (never activated) — nothing for the
            # supervisor to evacuate, nothing for replay to budget
            raise self.fail_exc
        if action == "fail":
            for req in self._queue:
                slot = self._free.pop(0)
                self._active[slot] = req
                self._generated[slot] = list(
                    range(100, 100 + self.fail_gen))
            self._queue = []
            raise self.fail_exc
        out = [self._complete(r) for r in self._queue]
        self._queue = []
        return out


def _sup_cfg(**kw):
    kw.setdefault("watchdog_poll_s", 0.01)
    kw.setdefault("deadlines_s", {"step": 0.25})
    return SupervisorConfig(**kw)


# ---------------------------------------------------------------------------
# watchdog (acceptance: hung dispatch → contained suspect event,
# dispatcher stays live for new work — within the test timeout)
# ---------------------------------------------------------------------------


def test_watchdog_converts_hung_dispatch_into_suspect_event():
    eng = StubEngine(script=["block"])
    runner = AsyncEngineRunner(eng, supervisor=_sup_cfg()).start()
    try:
        h = runner.submit([1, 2, 3], 4, correlation_id="hang-1")
        t0 = time.monotonic()
        with pytest.raises(EngineSuspect) as ei:
            h.result(timeout=10.0)
        # the watchdog failed the handle LONG before the 15s block
        # ends — the caller is unwedged, not waiting out the hang
        assert time.monotonic() - t0 < 5.0
        assert ei.value.kind == "step"
        assert ei.value.deadline_s == 0.25
        assert "suspect" in str(ei.value)
        assert runner.suspect_failures == 1
        assert runner.supervisor.watchdog_trips >= 1
        # release the hang: the dispatcher returns, evacuates the
        # zombie work, and keeps serving NEW requests
        eng.release.set()
        h2 = runner.submit([5, 6], 3)
        c = h2.result(timeout=10.0)
        assert c.tokens and c.finish_reason == "length"
    finally:
        eng.release.set()
        assert runner.stop()


def test_watchdog_pending_submits_survive_the_hang():
    """Handles already inside the engine fail at trip time; submits
    that arrive DURING the hang never touched the suspect engine and
    must serve after recovery."""
    eng = StubEngine(script=["block"])
    runner = AsyncEngineRunner(eng, supervisor=_sup_cfg()).start()
    try:
        h_stuck = runner.submit([1, 2, 3], 4)
        with pytest.raises(EngineSuspect):
            h_stuck.result(timeout=10.0)
        h_pending = runner.submit([9, 9], 2)   # arrives mid-hang
        eng.release.set()
        assert h_pending.result(timeout=10.0).tokens
    finally:
        eng.release.set()
        runner.stop()


# ---------------------------------------------------------------------------
# request replay (stub-level: stitching, budget, EngineFailed)
# ---------------------------------------------------------------------------


def test_replay_stitches_one_completion_with_original_identity():
    eng = StubEngine(script=["fail"], fail_gen=2)
    runner = AsyncEngineRunner(
        eng, supervisor=_sup_cfg(replay_budget=2)).start()
    try:
        h = runner.submit([1, 2, 3], 6, correlation_id="r-1")
        c = h.result(timeout=10.0)
        # original identity: the caller's prompt length, not the
        # continuation's (prompt+2 salvaged tokens)
        assert c.prompt_len == 3
        # stitched stream: 2 salvaged tokens + 4 continuation tokens
        assert c.tokens[:2] == [100, 101]
        assert len(c.tokens) == 6
        assert c.finish_reason == "length"
        assert runner.replayed == 1 and runner.recovered == 1
        assert runner.replay_failed == 0
        # the continuation resubmitted prompt+generated with the
        # remaining budget and the caller's correlation id
        prompt2, mnt2, kw2 = eng.submits[-1]
        assert prompt2 == [1, 2, 3, 100, 101]
        assert mnt2 == 4
        assert kw2.get("correlation_id") == "r-1"
    finally:
        runner.stop()


def test_replay_budget_spent_raises_structured_engine_failed():
    eng = StubEngine(script=["fail", "fail", "fail", "fail"],
                     fail_gen=1)
    runner = AsyncEngineRunner(
        eng, supervisor=_sup_cfg(replay_budget=2)).start()
    try:
        h = runner.submit([4, 5], 8, correlation_id="doomed")
        with pytest.raises(EngineFailed) as ei:
            h.result(timeout=10.0)
        e = ei.value
        assert e.correlation_id == "doomed"
        assert e.attempts == 2                 # budget, then terminal
        assert e.reason == "replay-budget"
        assert "replay" in str(e)
        fields = e.as_event_fields()
        assert fields["correlation_id"] == "doomed"
        assert runner.replayed == 2 and runner.replay_failed == 1
    finally:
        runner.stop()


def test_replay_without_supervisor_keeps_legacy_fail_all():
    eng = StubEngine(script=["fail"])
    runner = AsyncEngineRunner(eng).start()
    try:
        h = runner.submit([1, 2], 4)
        with pytest.raises(RuntimeError, match="stub dispatch died"):
            h.result(timeout=10.0)
    finally:
        runner.stop()


def test_replay_resolves_request_whose_output_was_already_complete():
    """A failed step that had already harvested a request's FULL
    output (multi-window dispatches) must resolve the handle with its
    finished completion — not burn a replay or fail it."""
    eng = StubEngine(script=["fail"], fail_gen=6)   # == max_new below
    runner = AsyncEngineRunner(
        eng, supervisor=_sup_cfg(replay_budget=2)).start()
    try:
        h = runner.submit([1, 2, 3], 6)
        c = h.result(timeout=10.0)
        assert c.tokens == [100, 101, 102, 103, 104, 105]
        assert c.finish_reason == "length"
        assert c.prompt_len == 3
        assert runner.replayed == 0 and runner.replay_failed == 0
        assert len(eng.submits) == 1          # never resubmitted
    finally:
        runner.stop()


def test_suspect_recovery_purges_waiterless_queued_work():
    """The watchdog failed EVERY in-engine handle — queued requests
    included. After the stuck step returns, their queued work must be
    purged, not computed for nobody."""
    eng = StubEngine(script=["block"])
    runner = AsyncEngineRunner(eng, supervisor=_sup_cfg()).start()
    try:
        handles = [runner.submit([i, i + 1], 4) for i in range(3)]
        for h in handles:
            with pytest.raises(EngineSuspect):
                h.result(timeout=10.0)
        assert eng._queue                     # zombies queued in-engine
        eng.release.set()
        # new work serves; by then the zombie queue must be gone
        h2 = runner.submit([9, 9], 2)
        assert h2.result(timeout=10.0).tokens
        assert eng._queue == []
        # completed counts only real resolutions, not dropped zombies
        assert runner.completed <= 1 + len(handles)
    finally:
        eng.release.set()
        runner.stop()


def test_persistent_admit_failure_terminates_structured():
    """Review regression: a persistently failing admission wave
    requeues its requests (never active → never replay-budgeted) —
    the consecutive-failure gate must declare the engine unhealthy
    and fail the stuck handles structured instead of raise/requeue
    looping until the caller's own timeout."""
    eng = StubEngine(script=["fail_queued"] * 20)
    runner = AsyncEngineRunner(
        eng, supervisor=_sup_cfg(max_consecutive_failures=3)).start()
    try:
        h = runner.submit([1, 2, 3], 4, correlation_id="stuck")
        with pytest.raises(EngineFailed) as ei:
            h.result(timeout=10.0)
        assert ei.value.reason == "engine-unhealthy"
        assert "consecutive failed steps" in str(ei.value)
        assert eng._queue == []             # purged, not looping
        # a success after the fault clears resets the counter and the
        # dispatcher serves new traffic normally
        eng.script = []
        h2 = runner.submit([5, 6], 3)
        assert h2.result(timeout=10.0).tokens
        assert runner.supervisor.consecutive_failures == 0
    finally:
        runner.stop()


def test_replay_overflowing_prompt_limit_fails_structured():
    """Review regression: a continuation whose prompt+generated no
    longer fits prompt_limit must fail structured — submit would
    silently head-truncate it and the replay would diverge from the
    fault-free stream."""
    eng = StubEngine(script=["fail"], fail_gen=3)
    eng.prompt_limit = 5                    # prompt 3 + gen 3 = 6 > 5
    runner = AsyncEngineRunner(
        eng, supervisor=_sup_cfg(replay_budget=4)).start()
    try:
        h = runner.submit([1, 2, 3], 10, correlation_id="overflow")
        with pytest.raises(EngineFailed) as ei:
            h.result(timeout=10.0)
        assert ei.value.reason == "continuation-too-long"
        assert ei.value.correlation_id == "overflow"
        assert len(eng.submits) == 1        # never resubmitted
    finally:
        runner.stop()


# ---------------------------------------------------------------------------
# satellite: stop() join-timeout must fail outstanding handles
# ---------------------------------------------------------------------------


def test_stop_join_timeout_fails_handles_with_stuck_state():
    eng = StubEngine(script=["block"])
    runner = AsyncEngineRunner(eng).start()
    h = runner.submit([1, 2, 3], 4)
    time.sleep(0.1)                     # let the dispatcher enter step()
    t0 = time.monotonic()
    joined = runner.stop(timeout=0.3)
    assert time.monotonic() - t0 < 5.0
    assert joined is False              # condition returned, not hidden
    with pytest.raises(EngineSuspect) as ei:
        h.result(timeout=1.0)
    msg = str(ei.value)
    assert "failed to join" in msg
    assert "engine.step()" in msg       # names the stuck state
    eng.release.set()                   # let the daemon thread die


def test_stop_clean_join_returns_true():
    eng = StubEngine()
    runner = AsyncEngineRunner(eng).start()
    h = runner.submit([1, 2], 3)
    assert h.result(timeout=10.0).tokens
    assert runner.stop() is True


# ---------------------------------------------------------------------------
# satellite: Handle.result timeout enrichment
# ---------------------------------------------------------------------------


def test_result_timeout_names_request_and_correlation_id():
    h = Handle(request_id=41, correlation_id="corr-41")
    with pytest.raises(TimeoutError) as ei:
        h.result(timeout=0.05)
    msg = str(ei.value)
    assert "request_id=41" in msg
    assert "correlation_id=corr-41" in msg
    assert "not finished after" in msg      # elapsed time present
    h2 = Handle()                            # defaults stay readable
    with pytest.raises(TimeoutError) as ei2:
        h2.result(timeout=0.01)
    assert "correlation_id=<none>" in str(ei2.value)


# ---------------------------------------------------------------------------
# satellite: _report_engine_error best-effort guarantees
# ---------------------------------------------------------------------------


class _BoomTelemetry:
    def record_error(self, exc):
        raise RuntimeError("telemetry imploded")


class _GoodTelemetry:
    def __init__(self):
        self.recorded = []

    def record_error(self, exc):
        self.recorded.append(exc)
        return {"correlation_ids": ["c-1"], "in_flight": [1],
                "dump_path": "/tmp/dump.json"}


class _BoomReporter:
    def __init__(self):
        self.calls = 0

    def report(self, exc, context):
        self.calls += 1
        raise RuntimeError("reporter imploded")


class _GoodReporter:
    def __init__(self):
        self.calls = []

    def report(self, exc, context):
        self.calls.append((exc, context))


def test_report_engine_error_survives_raising_telemetry():
    """A record_error that itself raises must neither mask the engine
    failure (the handle still sees the ORIGINAL exception) nor stop
    the error reporter from being called (without dump context)."""
    eng = StubEngine(script=["fail"],
                     fail_exc=RuntimeError("original engine failure"))
    eng.telemetry = _BoomTelemetry()
    reporter = _GoodReporter()
    runner = AsyncEngineRunner(eng, error_reporter=reporter).start()
    try:
        h = runner.submit([1, 2], 4)
        with pytest.raises(RuntimeError, match="original engine "
                                               "failure"):
            h.result(timeout=10.0)
        assert len(reporter.calls) == 1
        exc, context = reporter.calls[0]
        assert "original engine failure" in str(exc)
        assert context["component"] == "engine-dispatch"
        assert "flight_record" not in context     # dump never happened
        # the dispatcher survived: a new request still serves
        assert runner.submit([3], 2).result(timeout=10.0).tokens
    finally:
        runner.stop()


def test_report_engine_error_survives_raising_reporter():
    """A reporter that raises must not mask or amplify the original
    failure either — and the flight-recorder dump it was handed still
    happened first."""
    eng = StubEngine(script=["fail"],
                     fail_exc=RuntimeError("original engine failure"))
    tele = _GoodTelemetry()
    eng.telemetry = tele
    reporter = _BoomReporter()
    runner = AsyncEngineRunner(eng, error_reporter=reporter).start()
    try:
        h = runner.submit([1, 2], 4)
        with pytest.raises(RuntimeError, match="original engine "
                                               "failure"):
            h.result(timeout=10.0)
        assert reporter.calls == 1
        assert len(tele.recorded) == 1          # dump happened first
        assert runner.submit([3], 2).result(timeout=10.0).tokens
    finally:
        runner.stop()


# ---------------------------------------------------------------------------
# invariant audit (stub-level)
# ---------------------------------------------------------------------------


def test_audit_repairs_slot_table_and_quarantines_lost_slots():
    eng = StubEngine()
    sup = EngineSupervisor(eng, _sup_cfg())
    req = SimpleNamespace(request_id=7, prompt=[1, 2],
                          max_new_tokens=4, cache_eligible_tokens=None,
                          correlation_id="", tenant="", priority="",
                          deadline_at=float("inf"))
    # corrupt the tables: slot 0 both free and active, slot 1 free
    # twice, slot 3 tracked nowhere, an orphan _generated entry
    eng._active[0] = req
    eng._generated[0] = [9]
    eng._free = [0, 1, 1, 2]
    eng._generated[2] = [8, 8]          # orphan (slot 2 not active)
    findings = sup.audit(repair=True)
    assert findings["free_while_active"] == [0]
    assert findings["duplicate_free_slots"] == [1]
    assert findings["quarantined_slots"] == [3]
    assert findings["generated_orphans"] == [2]
    assert eng._free == [1, 2]          # deduped, active slot removed
    assert 2 not in eng._generated
    assert sup.quarantined == [3]
    # a clean engine audits clean (and the repair is idempotent)
    assert sup.audit(repair=True) == {}


def test_resolve_supervisor_semantics():
    eng = StubEngine()
    assert resolve_supervisor(None, eng) is None
    assert resolve_supervisor(False, eng) is None
    sup = resolve_supervisor(True, eng)
    assert isinstance(sup, EngineSupervisor) and eng.supervisor is sup
    eng2 = StubEngine()
    sup2 = resolve_supervisor(SupervisorConfig(replay_budget=7), eng2)
    assert sup2.cfg.replay_budget == 7
    assert resolve_supervisor(sup2, eng2) is sup2
    with pytest.raises(ValueError, match="different engine"):
        resolve_supervisor(sup2, eng)
    with pytest.raises(ValueError):
        resolve_supervisor("yes", eng)




# ---------------------------------------------------------------------------
# prefix-cache pins and flush, on the port's shared-pool trie
# ---------------------------------------------------------------------------


def _published_trie(tokens, block=4):
    """A trie over a 6-block pool holding ``tokens``' whole blocks, adopted
    from a retiring slot's table as the paged engine publishes."""
    pool = BlockPool(decoder_config("tiny"), num_blocks=6, block_size=block,
                     kv_dtype=torch.float32, device="cpu")
    pc = PrefixCache(shared=pool)
    table = pool.alloc(pool.blocks_for(len(tokens)))
    adopted = pc.adopt_blocks(tokens, table, owned_from=0)
    pool.free([b for b in table if b not in adopted])
    return pool, pc


def test_audit_releases_leaked_prefix_pins():
    eng = StubEngine()
    _pool, pc = _published_trie(list(range(10)))
    eng._prefix = pc
    sup = EngineSupervisor(eng, _sup_cfg())
    # pin via a lookup under a request id that is NOT active: a leak
    m = pc.lookup(list(range(10)))
    assert m.tokens > 0 and pc.pinned_refcount > 0
    eng._prefix_pins[99] = m            # request 99 does not exist
    findings = sup.audit(repair=True)
    assert findings["leaked_pins"] == [99]
    assert pc.pinned_refcount == 0
    assert sup.released_pins == 1


def test_prefix_cache_flush_frees_everything():
    pool, pc = _published_trie(list(range(13)))
    assert pc.node_count == 3
    assert pc.flush() == 3
    assert pc.node_count == 0 and pool.free_blocks == pool.num_blocks
    assert pc.match_tokens(list(range(13))) == 0


def test_resource_breaker_lowers_and_restores_the_slot_cap():
    """The cap half of the JAX package's breaker case (the port has no
    scheduler): two exhaustions halve the cap, clean dispatches after the
    cooldown double it back, and the probe at full cap closes the
    breaker."""

    class _CapEngine(StubEngine):
        def __init__(self):
            super().__init__()
            self._slot_cap = self.num_slots

        def set_slot_cap(self, cap):
            self._slot_cap = max(1, min(self.num_slots, int(cap)))

    clk = _Clock()
    eng = _CapEngine()
    sup = EngineSupervisor(
        eng, SupervisorConfig(resource_breaker_threshold=2,
                              breaker_probe_after_s=10.0), clock=clk)
    oom = RuntimeError("RESOURCE_EXHAUSTED: out of memory while "
                       "allocating 1.2G")
    sup.on_dispatch_error("decode", oom)
    assert eng._slot_cap == 4           # threshold not reached yet
    sup.on_dispatch_error("decode", oom)
    assert eng._slot_cap == 2           # tripped: halved
    sup.on_dispatch_ok("decode")
    assert eng._slot_cap == 2           # cooldown not elapsed
    clk.t = 10.0
    sup.on_dispatch_ok("decode")
    assert eng._slot_cap == 4           # restored
    sup.on_dispatch_ok("decode")        # probe success at full cap
    assert sup.resource_breaker.state == "closed"


def test_supervisor_reads_missing_engine_members_with_getattr():
    """The port's engine has no handoff table (disaggregated roles) and no
    piggyback queue, and the supervisor reads those members, the chunk
    queue and the scheduler with getattr, as the reference does:
    containment and audit must run on an engine without them. The draft
    index and the chunking table the engine now has are read directly."""
    eng = StubEngine(script=["fail"])
    for name in ("_chunk_pending", "_prefilling", "_sched"):
        delattr(eng, name)
    assert not hasattr(eng, "_handoff")
    sup = EngineSupervisor(eng, _sup_cfg())
    eng.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError):
        eng.step()
    plan = sup.contain(RuntimeError("x"))
    assert [len(g) for _r, g in plan.evacuated] == [2]
    assert sup.audit(repair=True) == {}
    assert sup.purge_queued() == []


def test_repairing_audit_calls_the_engine_hook():
    eng = StubEngine()
    calls = []
    eng.on_repaired = lambda: calls.append(1)
    sup = EngineSupervisor(eng, _sup_cfg())
    sup.audit(repair=False)
    assert calls == []
    sup.audit(repair=True)
    assert calls == [1]
