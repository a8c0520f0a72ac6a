"""SLO-aware scheduler: admission, fairness, and load shedding.

The engines admit FIFO; under adversarial mixed traffic that FIFO is
the whole problem — a burst of long prompts monopolizes admission waves
and starves decode ITL, one chatty tenant starves everyone else, and
the only backpressure is the queue growing until the
``EngineQueueBacklogGrowing`` alert fires. This module owns the traffic
policy the serving literature converged on, as pure host-side state the
engines consult around their existing dispatch loop:

* **Chunked prefill** (Sarathi-style): the scheduler releases at most
  ``prefill_wave_tokens`` of prompt work per engine step, and prompts
  longer than ``chunk_tokens`` are split into fixed-size chunks
  dispatched BETWEEN decode windows (``GenerationEngine._chunk_step``
  — a seeded prefill over the slot's own partially-filled cache, the
  PR-1 ``prefill_attention_seeded`` machinery generalized into a
  continuation), so a 16k-token prompt costs many small ITL bumps
  instead of one multi-second stall.
* **Per-tenant fairness**: requests carry a ``tenant`` key and a
  priority lane (``interactive`` > ``batch``). Each lane runs weighted
  deficit-round-robin over tenant queues — every round a tenant's
  deficit grows by ``quantum_tokens x weight`` and it may release that
  many prompt tokens, so a tenant submitting 100x more work gets its
  weighted share, not the whole engine. Per-tenant token quotas cap
  queued backlog per tenant with an honest rejection instead of
  unbounded queueing.
* **SLO-aware load shedding**: a closed loop over the engine's own
  telemetry (``engine/telemetry.py`` spans: queue-wait p95, TTFT p99,
  occupancy) sheds the lowest-priority work FIRST — and everything at
  the hard cap — with a structured :class:`EngineOverloaded` carrying
  an honest ``retry_after_s``, surfaced as HTTP 429 + ``Retry-After``
  by the service layer (``services/http.py``) *before* the queue ever
  reaches the ``EngineQueueBacklogGrowing`` alert threshold.
* **Prefix-cache-aware placement**: at release time, requests sharing
  a radix-cache block prefix (same first-block digest) are pulled into
  the same admission wave, so template-sharing requests ride one
  seeded dispatch and the pool gather amortizes.

Everything in this module is import-light host code (no jax): the
service layer imports :class:`EngineOverloaded` for its 429 mapping
without touching the device stack, and the scheduler itself is unit-
testable without a device. The device-side mechanism (the chunked
prefill dispatch) lives in ``engine/generation.py``; the policy lives
here. Design notes: ``docs/SCHEDULER.md``.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

#: priority lanes, highest first — the shed order is the reverse
PRIORITIES = ("interactive", "batch")


class EngineOverloaded(Exception):
    """Structured admission rejection: the engine is shedding load.

    Carries everything the edge needs for an honest 429: how long the
    caller should back off (``retry_after_s``, from the scheduler's
    drain estimate, not a constant), which tenant/priority was shed,
    why, and the pipeline ``correlation_id`` so the rejection joins the
    request's trace in logs and error events."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0,
                 tenant: str = "", priority: str = "",
                 reason: str = "overloaded", correlation_id: str = ""):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.priority = priority
        self.reason = reason
        self.correlation_id = correlation_id

    def as_event_fields(self) -> dict:
        """The structured error-event payload (HTTP body / bus failure
        event tags)."""
        return {
            "error": str(self),
            "reason": self.reason,
            "retry_after_s": round(self.retry_after_s, 3),
            "tenant": self.tenant,
            "priority": self.priority,
            "correlation_id": self.correlation_id,
        }


def jain_index(values: Iterable[float]) -> float:
    """Jain's fairness index over per-tenant allocations: 1.0 is
    perfectly fair, 1/n is one tenant taking everything. The bench's
    ``fairness_jain_index`` column and the DRR property tests both use
    this definition, so they can never drift apart."""
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    s = sum(xs)
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return 1.0
    return (s * s) / (len(xs) * sq)


@dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs. Defaults are sized so the shed thresholds sit
    BELOW the ``EngineQueueBacklogGrowing`` alert's ``> 64`` queue
    depth — shedding is supposed to fire first (the alert firing means
    the scheduler failed), and the contract test in
    ``tests/test_engine_scheduler.py`` pins that ordering."""

    #: per-request prefill tokens per chunk dispatch: prompts longer
    #: than this split into chunks co-scheduled with decode windows
    chunk_tokens: int = 256
    #: total prompt tokens the scheduler releases into admission per
    #: engine step — the ITL bound: one step's prefill work can never
    #: exceed this
    prefill_wave_tokens: int = 2048
    #: DRR quantum: deficit granted per tenant per scheduling round
    quantum_tokens: int = 512
    #: tenant → DRR weight (share of admission tokens under contention)
    tenant_weights: dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    #: tenant → max QUEUED prompt tokens (0 = unlimited); beyond it the
    #: tenant's own submits shed while others keep flowing
    tenant_quota_tokens: dict[str, int] = field(default_factory=dict)
    default_quota_tokens: int = 0
    #: hard cap: total queued requests at which EVERYTHING sheds.
    #: Strictly below the EngineQueueBacklogGrowing threshold (64).
    max_queue_depth: int = 48
    #: batch-lane shed point: beyond this queued depth only interactive
    #: work admits (shed lowest priority first)
    batch_shed_depth: int = 32
    #: SLO bounds the closed loop sheds against (matching the alert
    #: pack: EngineTTFTP99High fires at 30s)
    ttft_p99_slo_s: float = 30.0
    queue_wait_p95_slo_s: float = 20.0
    #: completed-trace window the closed loop computes percentiles over
    signal_window: int = 64
    #: Retry-After clamp for the honest 429
    min_retry_after_s: float = 1.0
    max_retry_after_s: float = 60.0
    #: embedding-engine wave sizing: rows per encode dispatch (0 = the
    #: engine's own batch_size); halved under overload so an embed
    #: burst yields the host loop between tiles
    embed_wave_rows: int = 0
    #: embedding burst hard cap per call (0 = unlimited): a burst
    #: larger than this sheds instead of monopolizing the device
    embed_max_burst_texts: int = 0
    #: paged-KV (kv_pool_blocks) free-block shed thresholds: fractions
    #: of the pool below which the batch lane sheds / everything sheds.
    #: The ratios apply to the engine's HEADROOM (free + evictable
    #: minus admitted worst-case claims), so pressure shows before the
    #: allocator actually runs dry.
    kv_low_ratio: float = 0.10
    kv_critical_ratio: float = 0.02
    #: disaggregated-role shed thresholds (engine ``role="prefill"``):
    #: finished prefills awaiting handoff (slot-parked + exported-but-
    #: unadmitted) beyond this depth shed the batch lane (decode chips
    #: are the bottleneck — prefilling further ahead only pins pool
    #: blocks behind the handoff); at 2x everything sheds. The engine
    #: additionally stops RELEASING waves at its ``handoff_high`` mark
    #: (default num_slots/2), so the shed levels here are the
    #: door-side mirror of that hold — decode ITL stays flat while
    #: prefill chips saturate on work decode can actually take. Size
    #: this to the role PAIR: the backlog signal is bounded by
    #: prefill slots + the wrapper's capacity-capped pending queue,
    #: so a threshold above that sum can never fire.
    handoff_shed_depth: int = 16


@dataclass
class _TenantState:
    deficit: float = 0.0
    queued_tokens: int = 0
    admitted_tokens: int = 0          # fairness ledger (jain_index)
    shed: int = 0


class Scheduler:
    """Admission owner for one engine (or shared across engines).

    The engine calls, per step:

    * :meth:`observe` — feed the closed loop (queue depth, occupancy,
      telemetry spans); recomputes the overload level and the
      Retry-After drain estimate.
    * :meth:`select` — pop the next wave's requests in DRR order
      (interactive lane first), bounded by a token budget and the free
      slot count, with prefix-placement grouping.

    Callers (services / async runner / the engine's ``submit``) call
    :meth:`check_admission` first; it raises :class:`EngineOverloaded`
    when the request should shed. All methods are cheap dict/deque work
    under the GIL — safe to call from a caller thread while the
    dispatcher owns the engine, same discipline as the telemetry
    counters."""

    def __init__(self, cfg: SchedulerConfig | None = None, *,
                 telemetry: Any = None):
        self.cfg = cfg or SchedulerConfig()
        #: engine telemetry (EngineTelemetry | None) — the sched_*
        #: gauges/counters export through it when present
        self.telemetry = telemetry
        self._queues: dict[tuple[str, str],
                           "collections.deque"] = {}
        self._tenants: dict[str, _TenantState] = {}
        self._rotation: list[str] = []     # DRR visit order
        #: closed-loop state (observe())
        self.overload_level = 0            # 0 ok | 1 shed batch | 2 all
        #: external pressure floor on the overload level, set by the
        #: engine supervisor's resource breaker (engine/supervisor.py):
        #: repeated device resource exhaustion lowers the engine's
        #: occupancy cap AND raises this, so the shed loop starts
        #: rejecting batch work at the edge instead of re-OOMing.
        #: Cleared by the supervisor when capacity is restored.
        self.pressure = 0
        self.retry_after_s = self.cfg.min_retry_after_s
        self.last_signals: dict[str, float] = {}
        #: requests staged inside the engine (queue/prefilling/chunking)
        #: as of the last observe() — check_admission counts them toward
        #: the depth caps so a burst between steps cannot blow past them
        self._engine_staged = 0
        #: counters (bench/tests read these; metrics mirror them)
        self.shed_total = 0
        self.submitted_total = 0

    # -- queue state ----------------------------------------------------

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queued_for(self, tenant: str) -> int:
        return sum(len(q) for (t, _lane), q in self._queues.items()
                   if t == tenant)

    def tenant_depths(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for (t, _lane), q in self._queues.items():
            out[t] = out.get(t, 0) + len(q)
        return out

    def fairness_snapshot(self) -> dict[str, float]:
        """Per-tenant admitted prompt tokens normalized by weight — the
        quantity DRR equalizes under contention; feed it to
        :func:`jain_index` for the bench column."""
        return {t: st.admitted_tokens / self._weight(t)
                for t, st in self._tenants.items()
                if st.admitted_tokens}

    #: hard cap on tracked tenant states: beyond it, NEW tenant names
    #: fold into one overflow bucket — an adversarial spray of unique
    #: tenant strings must not grow host memory, the DRR rotation, or
    #: the per-tenant Prometheus series without bound
    MAX_TENANTS = 256

    def _weight(self, tenant: str) -> float:
        w = self.cfg.tenant_weights.get(tenant, self.cfg.default_weight)
        return max(1e-6, float(w))

    def _tenant_key(self, tenant: str) -> str:
        if tenant in self._tenants \
                or len(self._tenants) < self.MAX_TENANTS:
            return tenant
        return "__overflow__"

    def _state(self, tenant: str) -> _TenantState:
        tenant = self._tenant_key(tenant)
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState()
            self._rotation.append(tenant)
        return st

    # -- admission gate -------------------------------------------------

    def check_admission(self, *, tenant: str = "",
                        priority: str = "interactive",
                        prompt_tokens: int = 0,
                        correlation_id: str = "") -> None:
        """Raise :class:`EngineOverloaded` when this request should be
        shed; return normally when it may enqueue. Shed order: tenant
        quota first (that tenant's own backlog), then the batch lane at
        ``batch_shed_depth`` / overload level 1, then everything at
        ``max_queue_depth`` / level 2."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}; one of {PRIORITIES}")
        depth = self.queued + self._engine_staged
        quota = self.cfg.tenant_quota_tokens.get(
            tenant, self.cfg.default_quota_tokens)
        if quota and self._state(tenant).queued_tokens + prompt_tokens \
                > quota:
            self._shed(tenant, priority, "tenant-quota", correlation_id,
                       f"tenant {tenant!r} over its {quota}-token "
                       f"queued quota")
        if depth >= self.cfg.max_queue_depth or self.overload_level >= 2:
            self._shed(tenant, priority, "queue-full", correlation_id,
                       f"admission queue at {depth} (cap "
                       f"{self.cfg.max_queue_depth})")
        if priority != "interactive" and (
                depth >= self.cfg.batch_shed_depth
                or self.overload_level >= 1):
            self._shed(tenant, priority, "slo-pressure", correlation_id,
                       "batch lane shed under SLO pressure "
                       f"(queue {depth}, level {self.overload_level})")

    def _shed(self, tenant: str, priority: str, reason: str,
              correlation_id: str, message: str) -> None:
        self.shed_total += 1
        self._state(tenant).shed += 1
        if self.telemetry is not None:
            # folded key: the shed counter's tenant label must obey the
            # same cardinality cap as the gauges
            self.telemetry.on_shed(self._tenant_key(tenant), priority)
        raise EngineOverloaded(
            f"engine overloaded: {message}; retry after "
            f"{self.retry_after_s:.1f}s",
            retry_after_s=self.retry_after_s, tenant=tenant,
            priority=priority, reason=reason,
            correlation_id=correlation_id)

    def enqueue(self, req: Any) -> None:
        """Queue an admitted request (engine ``submit`` calls this after
        ``check_admission`` passed). ``req`` needs ``tenant``,
        ``priority`` and ``prompt`` attributes (``generation.Request``)."""
        tenant = self._tenant_key(getattr(req, "tenant", "") or "")
        lane = getattr(req, "priority", "") or "interactive"
        self.submitted_total += 1
        self._state(tenant).queued_tokens += len(req.prompt)
        self._queues.setdefault((tenant, lane),
                                collections.deque()).append(req)
        self._export_gauges()

    # -- closed loop ----------------------------------------------------

    def observe(self, *, queued: int, active: int, num_slots: int,
                telemetry: Any = None, now: float | None = None,
                free_blocks: int | None = None,
                total_blocks: int | None = None,
                handoff_backlog: int | None = None) -> dict:
        """Recompute the overload level and Retry-After estimate from
        the engine's own signals. Called once per engine step (and from
        tests with synthetic traces).

        Shed policy: level 1 (batch lane sheds) when the latency SLOs
        are violated while the slots are actually saturated — high TTFT
        with idle slots is admission hysteresis, not overload — or when
        the queue passes ``batch_shed_depth``; level 2 (everything
        sheds) at ``max_queue_depth``. The queue-depth terms mean the
        loop degrades gracefully when telemetry is disabled.

        Paged engines (``kv_pool_blocks``) report FREE-BLOCK headroom
        (``free_blocks``: free + evictable minus admitted work's
        worst-case remaining claims, out of ``total_blocks``) — the
        load-shedding signal moves from free-slot counting to
        free-block accounting: under ``kv_low_ratio`` of the pool the
        batch lane sheds, under ``kv_critical_ratio`` everything does,
        whatever the queue depth says."""
        now = time.monotonic() if now is None else now
        self._engine_staged = max(0, queued - self.queued)
        tele = telemetry if telemetry is not None else self.telemetry
        qwait_p95 = ttft_p99 = 0.0
        rate = 0.0
        traces = []
        if tele is not None and getattr(tele, "completed", None):
            traces = list(tele.completed)[-self.cfg.signal_window:]
        if traces:
            qwaits = sorted(t.queue_wait_s for t in traces)
            ttfts = sorted(t.ttft_s for t in traces)
            qwait_p95 = qwaits[min(len(qwaits) - 1,
                                   int(0.95 * (len(qwaits) - 1)))]
            ttft_p99 = ttfts[min(len(ttfts) - 1,
                                 int(0.99 * (len(ttfts) - 1)))]
            span = max(1e-3, now - min(t.finished_at for t in traces))
            rate = len(traces) / span
        occupancy = active / num_slots if num_slots else 0.0
        slo_violated = (qwait_p95 > self.cfg.queue_wait_p95_slo_s
                        or ttft_p99 > self.cfg.ttft_p99_slo_s)
        level = 0
        if (slo_violated and occupancy >= 0.75) \
                or queued >= self.cfg.batch_shed_depth:
            level = 1
        if queued >= self.cfg.max_queue_depth:
            level = 2
        kv_ratio = None
        if free_blocks is not None and total_blocks:
            kv_ratio = max(0.0, free_blocks) / total_blocks
            if kv_ratio < self.cfg.kv_critical_ratio:
                level = 2
            elif kv_ratio < self.cfg.kv_low_ratio:
                level = max(level, 1)
        if handoff_backlog is not None and self.cfg.handoff_shed_depth:
            # prefill-role engines: parked handoffs mean the DECODE
            # side is the bottleneck — shed at the door instead of
            # prefilling work nothing can decode yet
            if handoff_backlog >= 2 * self.cfg.handoff_shed_depth:
                level = 2
            elif handoff_backlog >= self.cfg.handoff_shed_depth:
                level = max(level, 1)
        level = max(level, min(2, self.pressure))
        self.overload_level = level
        # Honest Retry-After: time to drain the current backlog at the
        # recently observed completion rate, clamped. No observed rate
        # with a standing backlog means the drain time is UNKNOWN —
        # advertise the max backoff rather than an optimistic guess.
        if rate > 0:
            est = queued / rate
        else:
            est = self.cfg.max_retry_after_s if queued else 0.0
        self.retry_after_s = min(
            self.cfg.max_retry_after_s,
            max(self.cfg.min_retry_after_s, est))
        self.last_signals = {
            "queue_wait_p95_s": round(qwait_p95, 6),
            "ttft_p99_s": round(ttft_p99, 6),
            "occupancy": round(occupancy, 4),
            "completion_rate": round(rate, 4),
            "queued": queued,
            "overload_level": level,
            "retry_after_s": round(self.retry_after_s, 3),
        }
        if kv_ratio is not None:
            self.last_signals["kv_headroom_ratio"] = round(kv_ratio, 4)
        if handoff_backlog is not None:
            self.last_signals["handoff_backlog"] = int(handoff_backlog)
        self._export_gauges()
        return self.last_signals

    # -- per-request deadlines (engine/supervisor.py policy) ------------

    def drop_expired(self, now: float | None = None) -> list:
        """Remove queued requests whose ``deadline_at`` has passed and
        return them (the engine retires each with
        ``finish_reason="deadline"`` — expired work is DROPPED, never
        computed). The per-tenant queued-token ledgers are repaid so
        quota accounting stays honest."""
        now = time.monotonic() if now is None else now
        out: list = []
        for (tenant, _lane), q in self._queues.items():
            if not q:
                continue
            keep = [r for r in q
                    if getattr(r, "deadline_at", float("inf")) > now]
            if len(keep) == len(q):
                continue
            st = self._tenants[tenant]
            for r in q:
                if getattr(r, "deadline_at", float("inf")) <= now:
                    out.append(r)
                    st.queued_tokens = max(
                        0, st.queued_tokens - len(r.prompt))
            q.clear()
            q.extend(keep)
        if out:
            self._export_gauges()
        return out

    def purge(self) -> list:
        """Drain EVERY tenant queue, repaying the queued-token ledgers
        and re-exporting the gauges; returns the dropped requests. The
        engine supervisor uses this after a suspect event (the dropped
        requests' handles were already failed — computing them would
        serve nobody)."""
        out: list = []
        for (tenant, _lane), q in self._queues.items():
            if not q:
                continue
            st = self._tenants[tenant]
            for r in q:
                out.append(r)
                st.queued_tokens = max(
                    0, st.queued_tokens - len(r.prompt))
            q.clear()
        if out:
            self._export_gauges()
        return out

    def recount_queued_tokens(self) -> dict[str, tuple[int, int]]:
        """Recompute every tenant's queued-token ledger from the
        actual queues; returns ``{tenant: (recorded, actual)}`` for
        the ones that drifted (already repaired). The supervisor's
        post-failure invariant audit calls this — ledger drift would
        silently skew quota enforcement forever."""
        actual: dict[str, int] = {}
        for (tenant, _lane), q in self._queues.items():
            actual[tenant] = actual.get(tenant, 0) + sum(
                len(r.prompt) for r in q)
        drift: dict[str, tuple[int, int]] = {}
        for tenant, st in self._tenants.items():
            want = actual.get(tenant, 0)
            if st.queued_tokens != want:
                drift[tenant] = (st.queued_tokens, want)
                st.queued_tokens = want
        if drift:
            self._export_gauges()
        return drift

    # -- wave composition (DRR + prefix placement) ----------------------

    def select(self, *, max_requests: int,
               token_budget: int | None = None,
               cost_fn: Callable[[Any], int] | None = None,
               placement_key: Callable[[Any], Any] | None = None
               ) -> list:
        """Pop the next admission wave in weighted-DRR order.

        Interactive lane drains before the batch lane ever runs (strict
        priority; the fairness guarantee is *within* a lane). Each
        visited tenant's deficit grows by ``quantum x weight`` per
        round and shrinks by the cost of every request it releases;
        ``cost_fn`` defaults to prompt length — the engine passes the
        prefix-cache SUFFIX length so cached prompts cost what they
        actually prefill. ``placement_key`` groups requests sharing a
        radix-cache prefix into the same wave (the pulled request's own
        tenant still pays the deficit, so fairness accounting stays
        honest). A request larger than the whole budget is released
        alone rather than starved forever."""
        cost_fn = cost_fn or (lambda r: len(r.prompt))
        budget = (token_budget if token_budget is not None
                  else self.cfg.prefill_wave_tokens)
        out: list = []
        for lane in PRIORITIES:
            if len(out) >= max_requests or budget <= 0:
                break
            picked, spent = self._select_lane(
                lane, max_requests - len(out), budget, cost_fn,
                placement_key, wave_empty=not out)
            budget -= spent
            out.extend(picked)
        if out:
            self._export_gauges()
        return out

    def _select_lane(self, lane: str, max_requests: int, budget: int,
                     cost_fn, placement_key, *, wave_empty: bool
                     ) -> tuple[list, int]:
        """Returns (released requests, tokens spent). ``wave_empty``
        gates the oversized-release escape: a request bigger than the
        whole budget may only go out when the WAVE (across lanes) has
        released nothing — otherwise one step could blow far past
        ``prefill_wave_tokens``, the bound chunked prefill exists to
        keep."""
        out: list = []
        spent = 0
        # bounded rounds: every round grants each queued tenant one
        # quantum; no progress in a full round means nothing affordable
        while len(out) < max_requests and budget > spent:
            progress = False
            for tenant in list(self._rotation):
                q = self._queues.get((tenant, lane))
                if not q:
                    # classic DRR: an idle queue's deficit resets so a
                    # silent tenant cannot bank an unbounded burst
                    if not self.queued_for(tenant):
                        self._tenants[tenant].deficit = 0.0
                    continue
                st = self._tenants[tenant]
                st.deficit += self.cfg.quantum_tokens \
                    * self._weight(tenant)
                while q and len(out) < max_requests:
                    cost = cost_fn(q[0])
                    if cost > st.deficit:
                        break
                    if cost > budget - spent and (out or not wave_empty):
                        return out, spent
                    req = q.popleft()
                    self._charge(st, req, cost)
                    spent += cost
                    out.append(req)
                    progress = True
                    if placement_key is not None:
                        got = self._pull_same_prefix(
                            lane, placement_key(req), placement_key,
                            cost_fn, max_requests - len(out),
                            budget - spent)
                        for r2, c2 in got:
                            spent += c2
                            out.append(r2)
            if not progress:
                break
        return out, spent

    def _pull_same_prefix(self, lane, key, placement_key, cost_fn,
                          room: int, budget: int) -> list:
        """Prefix-cache-aware placement: pull requests whose placement
        key (first radix block digest) matches ``key`` into this wave,
        from ANY tenant's queue in the lane — each pull still charges
        its own tenant's deficit, so the pull only reorders a tenant's
        near-term share, never grows it."""
        if key is None or room <= 0:
            return []
        got = []
        for tenant in list(self._rotation):
            q = self._queues.get((tenant, lane))
            if not q:
                continue
            st = self._tenants[tenant]
            keep = []
            while q and len(got) < room:
                r = q.popleft()
                c = cost_fn(r)
                # Deficit DEBT model: the pull charges the tenant even
                # past zero — its own DRR releases then stall until the
                # debt is repaid by later quanta, so riding a shared
                # prefix reorders a tenant's near-term share without
                # ever growing it.
                if placement_key(r) == key and c <= budget:
                    self._charge(st, r, c)
                    budget -= c
                    got.append((r, c))
                else:
                    keep.append(r)
            # mutate in place: the caller's DRR loop holds this deque
            keep.extend(q)
            q.clear()
            q.extend(keep)
            if len(got) >= room:
                break
        return got

    def _charge(self, st: _TenantState, req: Any, cost: int) -> None:
        st.deficit -= cost
        st.admitted_tokens += cost
        st.queued_tokens = max(0, st.queued_tokens - len(req.prompt))

    # -- embedding-engine wave sizing ------------------------------------

    def embed_admit(self, n_texts: int, *, tenant: str = "",
                    batch_size: int = 64,
                    correlation_id: str = "") -> int:
        """Admission + batch sizing for one ``embed_batch`` call.
        Returns the rows-per-dispatch cap: ``embed_wave_rows`` (or the
        engine's batch size), halved under overload so a burst yields
        between tiles. Sheds oversized bursts (``embed_max_burst_texts``)
        and everything at overload level 2 — embed work is batch-lane
        by definition."""
        if self.cfg.embed_max_burst_texts \
                and n_texts > self.cfg.embed_max_burst_texts:
            self._shed(tenant, "batch", "embed-burst", correlation_id,
                       f"embed burst of {n_texts} texts over the "
                       f"{self.cfg.embed_max_burst_texts} cap")
        if self.overload_level >= 2:
            self._shed(tenant, "batch", "queue-full", correlation_id,
                       "embed burst shed at overload level 2")
        # NOT credited to the DRR fairness ledger: admitted_tokens is
        # denominated in prompt tokens and feeds jain_index — mixing
        # text counts in would skew the fairness column's units.
        rows = self.cfg.embed_wave_rows or batch_size
        if self.overload_level >= 1:
            rows = max(1, rows // 2)
        return min(rows, batch_size)

    # -- metrics export --------------------------------------------------

    def _export_gauges(self) -> None:
        if self.telemetry is None:
            return
        self.telemetry.sched_gauges(
            self.tenant_depths(),
            {t: st.deficit for t, st in self._tenants.items()})


def resolve_scheduler(scheduler, *, telemetry: Any = None
                      ) -> Scheduler | None:
    """Engine-side ``scheduler=`` argument semantics (mirrors
    ``telemetry.resolve_telemetry``): None/False disables, True builds
    one with defaults, a :class:`SchedulerConfig` builds from it, a
    :class:`Scheduler` instance is shared as-is (multi-engine closed
    loop: the embedding engine seeing the generation engine's overload
    level is exactly how embed bursts stop starving chat traffic)."""
    if scheduler is None or scheduler is False:
        return None
    if scheduler is True:
        return Scheduler(telemetry=telemetry)
    if isinstance(scheduler, SchedulerConfig):
        return Scheduler(scheduler, telemetry=telemetry)
    if isinstance(scheduler, Scheduler):
        if scheduler.telemetry is None:
            scheduler.telemetry = telemetry
        return scheduler
    raise ValueError(
        f"scheduler must be None/bool, SchedulerConfig or Scheduler, "
        f"got {type(scheduler).__name__}")
