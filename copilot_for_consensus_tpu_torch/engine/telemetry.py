"""Engine flight recorder: request-lifecycle tracing + step telemetry.

The serving engines keep rich internal ledgers (``prefix_stats()``,
``spec_stats()``) but, before this module, none of it reached
``obs/metrics.py`` — a TTFT regression was invisible outside a one-shot
``bench.py`` artifact. This is the observability layer SURVEY.md §5
assigns to the TPU build, three pieces:

* **Request-lifecycle spans** (``RequestTrace``): one span per request
  carrying the pipeline ``correlation_id`` end-to-end — enqueue →
  admit (queue wait, prefix-cache hit / seeded split) → first token →
  retire — with the derived serving latencies every production LLM
  stack treats as the control surface for continuous batching: TTFT
  (time to first token), ITL (mean inter-token latency), e2e latency,
  and queue wait.
* **Step telemetry** (``StepRecord`` + ``FlightRecorder``): a bounded,
  lock-cheap ring buffer with one record per device dispatch — wave
  kind (prefill / prefill_seeded / decode / verify / piggyback /
  embed), batch occupancy, padding-bucket waste, draft acceptance,
  host wall time, and a monotonically increasing step id that matches
  the ``jax.profiler`` ``StepTraceAnnotation`` around the dispatch
  (``obs/profile.py:step_annotation``), so Perfetto device traces
  correlate with host-side records. The ring doubles as a **flight
  recorder**: dumpable as JSON on demand and automatically on engine
  error for post-mortems (``record_error`` → ``dump``), naming the
  requests in flight by ``correlation_id``.
* **Prometheus export**: every observation lands in an
  ``obs/metrics.py`` collector (an ``InMemoryMetrics`` by default, so
  ``telemetry.metrics.render_prometheus()`` works out of the box;
  services pass their shared collector instead). The emitted series
  are declared in ``METRICS`` — the registry the observability-pack
  contract test checks ``infra/grafana`` + ``infra/prometheus``
  references against, so a dashboard panel or alert on a typo'd
  ``copilot_engine_*`` series fails CI instead of rotting silently.

Everything here is strictly host-side: timestamps via
``time.monotonic()`` around dispatches the engines already sync on,
zero device work, no extra ``block_until_ready`` — the jaxlint
``host-sync-in-jit`` lane stays clean and measured overhead stays
under the 1% budget (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import collections
import json
import pathlib
import threading
import time
import weakref
from dataclasses import asdict, dataclass
from typing import Any

from copilot_for_consensus_tpu_torch.obs.metrics import (
    InMemoryMetrics,
    MetricsCollector,
    check_registry_labels,
)

# ---------------------------------------------------------------------------
# Metric registry — the single source of truth for what the telemetry
# layer emits. Names are collector-namespaced at render time
# ("copilot_" by default), so the full series name is e.g.
# ``copilot_engine_ttft_seconds``. The observability-pack contract test
# (tests/test_observability_pack.py) asserts every ``copilot_engine_*``
# series a dashboard or alert references exists here WITH the right
# type for the PromQL function applied to it (rate() needs a counter or
# histogram, deriv() needs a gauge — the PR-1 alert-bug class).
# ---------------------------------------------------------------------------

#: metric name (sans namespace) → (type, label names, help)
METRICS: dict[str, tuple[str, tuple[str, ...], str]] = {
    "engine_requests_total": (
        "counter", ("engine", "finish_reason"),
        "Requests retired, by finish reason "
        "(eos|length|deadline|error|handoff)."),
    "engine_tokens_total": (
        "counter", ("engine", "kind"),
        "Tokens through the engine: kind=prompt (prefilled), "
        "kind=prompt_cached (skipped via prefix reuse), "
        "kind=generated."),
    "engine_errors_total": (
        "counter", ("engine",),
        "Engine dispatch failures (each one also dumps the flight "
        "recorder)."),
    "engine_queue_wait_seconds": (
        "histogram", ("engine",),
        "Submit → admission-wave start."),
    "engine_ttft_seconds": (
        "histogram", ("engine",),
        "Submit → first token (the admission wave samples it)."),
    "engine_itl_seconds": (
        "histogram", ("engine",),
        "Mean inter-token latency per retired request: decode time / "
        "(generated tokens - 1)."),
    "engine_e2e_seconds": (
        "histogram", ("engine",),
        "Submit → retire."),
    "engine_step_seconds": (
        "histogram", ("engine", "kind"),
        "Host wall time per device dispatch, by wave kind (prefill|"
        "prefill_seeded|decode|verify|piggyback|embed)."),
    "engine_queue_depth": (
        "gauge", ("engine",),
        "Requests waiting for a slot (queued + piggyback-prefilling)."),
    "engine_slot_occupancy": (
        "gauge", ("engine",),
        "Active slots / total slots at the last step."),
    "engine_padding_waste_ratio": (
        "gauge", ("engine",),
        "Padded-but-dead fraction of the last dispatch's token grid "
        "(bucket/pow2 padding the program computes and drops)."),
    "engine_prefix_hit_rate": (
        "gauge", ("engine",),
        "Prefix-cache hit rate over admission lookups "
        "(GenerationEngine.prefix_stats)."),
    "engine_spec_acceptance_rate": (
        "gauge", ("engine",),
        "Accepted / drafted speculative tokens "
        "(GenerationEngine.spec_stats)."),
    "engine_spec_draft_hit_rate": (
        "gauge", ("engine",),
        "Draft-index probes that produced a draft."),
    "engine_tokens_per_weight_pass": (
        "gauge", ("engine",),
        "Per-stream decode ledger across plain and verify paths; 1.0 "
        "is the vanilla decode wall."),
    # ---- SLO-aware scheduler (engine/scheduler.py) ----
    "engine_sched_tenant_queue_depth": (
        "gauge", ("engine", "tenant"),
        "Requests queued in the scheduler, per tenant."),
    "engine_sched_deficit": (
        "gauge", ("engine", "tenant"),
        "Weighted-DRR deficit (prompt tokens the tenant may release), "
        "per tenant."),
    "engine_sched_shed_total": (
        "counter", ("engine", "tenant", "priority"),
        "Requests shed with a structured EngineOverloaded rejection "
        "(surfaced as HTTP 429 + Retry-After at the edge)."),
    "engine_sched_prefill_chunks_total": (
        "counter", ("engine",),
        "Chunked-prefill continuation rows dispatched (long prompts "
        "split across decode steps to bound ITL)."),
    # ---- resilience: fault plane + supervisor (engine/faults.py,
    # engine/supervisor.py; docs/RESILIENCE.md) ----
    "engine_fault_injected_total": (
        "counter", ("engine", "kind", "mode"),
        "Faults fired by the injection plane (chaos harness; any "
        "nonzero value in production means a fault plan leaked in)."),
    "engine_fault_watchdog_trips_total": (
        "counter", ("engine", "kind"),
        "Dispatches that overran their per-kind watchdog deadline — "
        "the engine was marked suspect and in-flight handles failed "
        "structured instead of wedging their callers."),
    "engine_fault_breaker_state": (
        "gauge", ("engine", "breaker"),
        "Circuit-breaker state per degraded mode (0 closed, 0.5 "
        "half-open probe, 1 open): spec_verify open = spec decode "
        "disabled; resource open = occupancy cap lowered."),
    "engine_recovery_replays_total": (
        "counter", ("engine",),
        "In-flight requests resubmitted as prompt+generated "
        "continuations after an engine failure (request replay)."),
    "engine_recovery_failed_total": (
        "counter", ("engine",),
        "Requests terminally failed with structured EngineFailed "
        "after their replay budget was spent."),
    "engine_recovery_quarantined_slots": (
        "gauge", ("engine",),
        "Slots quarantined by the post-failure invariant audit "
        "(irreconcilable state; capacity reduced until restart)."),
    "engine_recovery_released_pins_total": (
        "counter", ("engine",),
        "Leaked prefix-cache pins released by the post-failure audit "
        "(a leaked pin would hold its pool blocks forever)."),
    "engine_recovery_deadline_expired_total": (
        "counter", ("engine",),
        "Requests dropped (not computed) because their per-request "
        "deadline_s expired before completion."),
    # ---- paged KV block pool (engine/kv_pool.py +
    # GenerationEngine(kv_pool_blocks=...); docs/ENGINE_PREFIX_CACHE.md
    # "Paged KV") ----
    "engine_kv_pool_free_blocks": (
        "gauge", ("engine",),
        "Free blocks in the paged KV pool (allocator free list; the "
        "EngineKVPoolExhausted alert watches this against a standing "
        "queue)."),
    "engine_kv_pool_pinned_blocks": (
        "gauge", ("engine",),
        "Pool blocks with outstanding pins — published prefix blocks "
        "the trie (and any admission reading them) holds."),
    "engine_kv_pool_fragmentation_ratio": (
        "gauge", ("engine",),
        "Internal fragmentation of allocated blocks: reserved-but-"
        "dead fraction (tail slack of partially filled blocks)."),
    "engine_kv_pool_zero_copy_admits_total": (
        "counter", ("engine",),
        "Seeded admissions that appended matched block ids to the "
        "slot's table instead of gathering a pool→slot copy "
        "(pointer-only prefix admission)."),
    "engine_kv_route": (
        "gauge", ("engine", "route"),
        "1 for the paged-attention dispatch route this engine "
        "resolved (route label: 'kernel' = Pallas in-place block "
        "reads, 'reference' = XLA working-set gather); dashboards "
        "join it against throughput to attribute route deltas."),
    # ---- disaggregated prefill/decode roles (engine/roles.py +
    # GenerationEngine(role=...); docs/PERF.md#multi-chip-serving) ----
    "engine_role_occupancy": (
        "gauge", ("engine", "engine_role"),
        "Occupied slots / total slots per role instance (active + "
        "chunking + handoff-parked) — the prefill/decode split's "
        "saturation view. Label is engine_role (not role): role is "
        "reserved for the cross-process aggregator's stamp."),
    "engine_role_handoff_blocks_total": (
        "counter", ("engine",),
        "KV pool blocks moved through the prefill→decode handoff "
        "(block-granular device-to-device transfers)."),
    "engine_role_handoff_wait_seconds": (
        "histogram", ("engine",),
        "Prefill-ready → decode-admitted wait per handed-off request "
        "(the disaggregation tax; the EngineKVHandoffStalled alert "
        "watches its p99 against a standing handoff backlog)."),
    # ---- durable request journal (engine/journal.py;
    # docs/RESILIENCE.md#process-lifecycle) ----
    "engine_journal_depth": (
        "gauge", ("engine",),
        "Unfinished requests in the durable engine journal (queued + "
        "in-flight); a depth that never drains while the engine is "
        "idle means rows leaked (EngineJournalBacklog alert)."),
    "engine_journal_replayed_total": (
        "counter", ("engine",),
        "Journaled requests resubmitted as prompt+generated "
        "continuations at warm restart (restart costs latency, not "
        "work)."),
    "engine_journal_checkpoint_lag": (
        "gauge", ("engine",),
        "Largest per-request accepted-token count not yet "
        "checkpointed to the journal — the tokens a crash right now "
        "would recompute."),
}

# Registration-time contract: reserved proc/role labels collide here,
# loudly, not at scrape time when the aggregator stamps them.
check_registry_labels(METRICS, owner="ENGINE_METRICS")

#: step-record kinds the engines emit (doc + test anchor)
STEP_KINDS = ("prefill", "prefill_seeded", "prefill_chunk", "decode",
              "verify", "piggyback", "embed")


def prometheus_series(namespace: str = "copilot") -> dict[str, str]:
    """Full series name → type, for contract tests and docs."""
    return {f"{namespace}_{name}": typ
            for name, (typ, _labels, _help) in METRICS.items()}


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@dataclass
class RequestTrace:
    """One request's lifecycle span. Timestamps are ``time.monotonic()``
    (latency math); ``enqueued_wall`` anchors the span to wall-clock for
    dump correlation with logs."""

    request_id: int
    correlation_id: str = ""
    prompt_len: int = 0
    enqueued_at: float = 0.0
    enqueued_wall: float = 0.0
    admitted_at: float = 0.0        # admission-wave start
    first_token_at: float = 0.0     # admission-wave end (first sample)
    finished_at: float = 0.0
    admit_kind: str = ""            # wave | seeded | piggyback | longctx
    prefix_hit_tokens: int = 0      # prompt tokens seeded from the pool
    new_tokens: int = 0
    finish_reason: str = ""
    # derived at retire (kept on the record so dumps are self-contained)
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    itl_s: float = 0.0
    e2e_s: float = 0.0

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class StepRecord:
    """One device dispatch as seen from the host. ``seq`` matches the
    ``StepTraceAnnotation`` step id around the dispatch, so a Perfetto
    device trace row and this record name the same step."""

    seq: int
    kind: str                 # one of STEP_KINDS
    t_wall: float             # time.time() at record (dump correlation)
    duration_s: float         # host wall time incl. the harvest sync
    rows: int = 0             # real rows (requests / active slots)
    batch: int = 0            # program batch width (incl. padding)
    tokens: int = 0           # real tokens processed or emitted
    padded_tokens: int = 0    # batch × bucket the program computed
    draft_tokens: int = 0     # verify waves: drafted
    accepted_tokens: int = 0  # verify waves: accepted
    route: str = ""           # paged dispatch route: kernel |
    #                           reference ("" = contiguous layout)

    @property
    def occupancy(self) -> float:
        return self.rows / self.batch if self.batch else 0.0

    @property
    def padding_waste(self) -> float:
        if self.padded_tokens <= 0:
            return 0.0
        dead = max(0, self.padded_tokens - self.tokens)
        return dead / self.padded_tokens

    def as_dict(self) -> dict:
        d = asdict(self)
        d["occupancy"] = round(self.occupancy, 4)
        d["padding_waste"] = round(self.padding_waste, 4)
        return d


class FlightRecorder:
    """Bounded ring of ``StepRecord``s. Append is one deque op under
    the GIL (the deque's maxlen does the eviction) — cheap enough to
    stay on by default in the serving loop."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._ring: "collections.deque[StepRecord]" = collections.deque(
            maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()

    def next_seq(self) -> int:
        """Allocate the next step id (also the StepTraceAnnotation
        step_num) BEFORE the dispatch, so the annotation and the record
        agree even if the dispatch raises."""
        with self._lock:
            self._seq += 1
            return self._seq

    def record(self, rec: StepRecord) -> StepRecord:
        self._ring.append(rec)
        return rec

    def records(self) -> list[StepRecord]:
        return list(self._ring)

    def as_dicts(self) -> list[dict]:
        return [r.as_dict() for r in self.records()]


# ---------------------------------------------------------------------------
# default dump dir — set by the test harness / service bootstrap via
# this setter (runtime environment access stays in the config layer;
# tests/conftest.py plumbs COPILOT_FLIGHT_RECORD_DIR through here for
# the CI failure artifact).
# ---------------------------------------------------------------------------

_default_dump_dir: str | None = None
#: live telemetry instances, so a test-failure hook can dump every
#: engine that existed when the failure happened
_live: "weakref.WeakSet[EngineTelemetry]" = weakref.WeakSet()


def set_default_dump_dir(path: str | None) -> None:
    global _default_dump_dir
    _default_dump_dir = path


def get_default_dump_dir() -> str | None:
    return _default_dump_dir


def dump_all(directory: str | None = None, tag: str = "flight") -> list[str]:
    """Dump every live telemetry instance to ``directory`` (default:
    the configured dump dir). Returns written paths; never raises —
    this runs from failure hooks where a second error would mask the
    first."""
    directory = directory or _default_dump_dir
    if not directory:
        return []
    out = []
    for i, tele in enumerate(list(_live)):
        try:
            out.append(tele.dump_to_file(directory=directory,
                                         tag=f"{tag}-{i}"))
        except Exception:
            pass
    return out


# ---------------------------------------------------------------------------
# the telemetry front-end engines talk to
# ---------------------------------------------------------------------------


class EngineTelemetry:
    """Flight recorder + span tracker + metrics exporter for one engine.

    All methods are cheap host work (dict ops, a few float subtractions,
    one metrics observation each) and are called from the engine's own
    serving thread around dispatches it already syncs on. The metrics
    collector is thread-safe, so a shared collector across engines is
    fine.
    """

    def __init__(self, *, engine: str = "generation",
                 num_slots: int = 0,
                 metrics: MetricsCollector | None = None,
                 recorder_capacity: int = 512,
                 completed_capacity: int = 4096,
                 dump_dir: str | None = None):
        self.engine_label = engine
        self.num_slots = num_slots
        self.metrics = metrics if metrics is not None else \
            InMemoryMetrics(namespace="copilot")
        self.recorder = FlightRecorder(recorder_capacity)
        self.dump_dir = dump_dir
        self._labels = {"engine": engine}
        self._traces: dict[int, RequestTrace] = {}      # in flight
        self.completed: "collections.deque[RequestTrace]" = \
            collections.deque(maxlen=completed_capacity)
        self.created_wall = time.time()
        self.errors = 0
        self._dump_seq = 0
        _live.add(self)

    # -- lifecycle ------------------------------------------------------

    def on_submit(self, request_id: int, prompt_len: int,
                  correlation_id: str = "") -> RequestTrace:
        tr = RequestTrace(
            request_id=request_id, correlation_id=correlation_id,
            prompt_len=prompt_len, enqueued_at=time.monotonic(),
            enqueued_wall=time.time())
        self._traces[request_id] = tr
        return tr

    def on_admit(self, request_id: int, *, wave_start: float,
                 admit_kind: str = "wave",
                 prefix_hit_tokens: int = 0) -> None:
        """Record admission for one request: the wave started at
        ``wave_start`` (monotonic) and its first token exists NOW (the
        admit program samples it; the caller invokes this right after
        the host fetch)."""
        tr = self._traces.get(request_id)
        if tr is None:
            return
        now = time.monotonic()
        tr.admitted_at = wave_start
        tr.first_token_at = now
        tr.admit_kind = admit_kind
        tr.prefix_hit_tokens = prefix_hit_tokens
        tr.queue_wait_s = max(0.0, wave_start - tr.enqueued_at)
        tr.ttft_s = now - tr.enqueued_at
        m, lb = self.metrics, self._labels
        m.observe("engine_queue_wait_seconds", tr.queue_wait_s, lb)
        m.observe("engine_ttft_seconds", tr.ttft_s, lb)

    def on_retire(self, request_id: int, *, new_tokens: int,
                  finish_reason: str) -> RequestTrace | None:
        tr = self._traces.pop(request_id, None)
        if tr is None:
            return None
        now = time.monotonic()
        tr.finished_at = now
        tr.new_tokens = new_tokens
        tr.finish_reason = finish_reason
        tr.e2e_s = now - tr.enqueued_at
        decode_s = now - (tr.first_token_at or now)
        tr.itl_s = decode_s / (new_tokens - 1) if new_tokens > 1 else 0.0
        self.completed.append(tr)
        m, lb = self.metrics, self._labels
        m.observe("engine_e2e_seconds", tr.e2e_s, lb)
        if new_tokens > 1:
            m.observe("engine_itl_seconds", tr.itl_s, lb)
        m.increment("engine_requests_total", 1.0,
                    {**lb, "finish_reason": finish_reason})
        m.increment("engine_tokens_total", float(new_tokens),
                    {**lb, "kind": "generated"})
        m.increment("engine_tokens_total",
                    float(tr.prompt_len - tr.prefix_hit_tokens),
                    {**lb, "kind": "prompt"})
        if tr.prefix_hit_tokens:
            m.increment("engine_tokens_total",
                        float(tr.prefix_hit_tokens),
                        {**lb, "kind": "prompt_cached"})
        return tr

    # -- steps ----------------------------------------------------------

    def next_step(self) -> int:
        return self.recorder.next_seq()

    def record_step(self, kind: str, duration_s: float, *,
                    seq: int | None = None, rows: int = 0,
                    batch: int = 0, tokens: int = 0,
                    padded_tokens: int = 0, draft_tokens: int = 0,
                    accepted_tokens: int = 0,
                    route: str = "") -> StepRecord:
        rec = StepRecord(
            seq=self.recorder.next_seq() if seq is None else seq,
            kind=kind, t_wall=time.time(), duration_s=duration_s,
            rows=rows, batch=batch, tokens=tokens,
            padded_tokens=padded_tokens, draft_tokens=draft_tokens,
            accepted_tokens=accepted_tokens, route=route)
        self.recorder.record(rec)
        m, lb = self.metrics, self._labels
        m.observe("engine_step_seconds", duration_s,
                  {**lb, "kind": kind})
        if batch:
            m.gauge("engine_slot_occupancy", rec.occupancy, lb)
        if padded_tokens:
            m.gauge("engine_padding_waste_ratio", rec.padding_waste, lb)
        return rec

    def gauge_queue(self, queue_depth: int, active: int | None = None
                    ) -> None:
        m, lb = self.metrics, self._labels
        m.gauge("engine_queue_depth", float(queue_depth), lb)
        if active is not None and self.num_slots:
            m.gauge("engine_slot_occupancy",
                    active / self.num_slots, lb)

    # -- scheduler (engine/scheduler.py) --------------------------------

    def sched_gauges(self, tenant_depths: dict[str, int],
                     deficits: dict[str, float] | None = None) -> None:
        """Per-tenant scheduler state → gauges. Tenant label defaults
        to "default" for the anonymous tenant so the series is always
        well-formed."""
        m, lb = self.metrics, self._labels
        for tenant, depth in tenant_depths.items():
            m.gauge("engine_sched_tenant_queue_depth", float(depth),
                    {**lb, "tenant": tenant or "default"})
        for tenant, d in (deficits or {}).items():
            m.gauge("engine_sched_deficit", float(d),
                    {**lb, "tenant": tenant or "default"})

    def on_shed(self, tenant: str, priority: str) -> None:
        self.metrics.increment(
            "engine_sched_shed_total", 1.0,
            {**self._labels, "tenant": tenant or "default",
             "priority": priority or "batch"})

    def on_prefill_chunks(self, rows: int = 1) -> None:
        self.metrics.increment("engine_sched_prefill_chunks_total",
                               float(rows), self._labels)

    # -- resilience (engine/faults.py, engine/supervisor.py) ------------

    def on_fault_injected(self, kind: str, mode: str) -> None:
        self.metrics.increment(
            "engine_fault_injected_total", 1.0,
            {**self._labels, "kind": kind, "mode": mode})

    def on_watchdog_trip(self, kind: str) -> None:
        self.metrics.increment("engine_fault_watchdog_trips_total", 1.0,
                               {**self._labels, "kind": kind})

    def breaker_gauge(self, breaker: str, state: float) -> None:
        """0 closed | 0.5 half-open | 1 open (CircuitBreaker.GAUGE)."""
        self.metrics.gauge("engine_fault_breaker_state", float(state),
                           {**self._labels, "breaker": breaker})

    def on_replay(self, n: int = 1) -> None:
        self.metrics.increment("engine_recovery_replays_total",
                               float(n), self._labels)

    def on_replay_failed(self, n: int = 1) -> None:
        self.metrics.increment("engine_recovery_failed_total",
                               float(n), self._labels)

    def gauge_quarantined(self, n: int) -> None:
        self.metrics.gauge("engine_recovery_quarantined_slots",
                           float(n), self._labels)

    def on_released_pins(self, n: int = 1) -> None:
        self.metrics.increment("engine_recovery_released_pins_total",
                               float(n), self._labels)

    def on_deadline_expired(self, n: int = 1) -> None:
        self.metrics.increment(
            "engine_recovery_deadline_expired_total", float(n),
            self._labels)

    # -- paged KV block pool (engine/kv_pool.py) ------------------------

    def gauge_kv_pool(self, free_blocks: int, pinned_blocks: int,
                      fragmentation_ratio: float) -> None:
        m, lb = self.metrics, self._labels
        m.gauge("engine_kv_pool_free_blocks", float(free_blocks), lb)
        m.gauge("engine_kv_pool_pinned_blocks", float(pinned_blocks),
                lb)
        m.gauge("engine_kv_pool_fragmentation_ratio",
                float(fragmentation_ratio), lb)

    def on_zero_copy_admits(self, n: int = 1) -> None:
        self.metrics.increment("engine_kv_pool_zero_copy_admits_total",
                               float(n), self._labels)

    def gauge_kv_route(self, route: str) -> None:
        """Resolved paged dispatch route ('kernel' | 'reference'),
        emitted once at engine build — a label-dimensioned constant
        gauge, the Prometheus idiom for build info."""
        self.metrics.gauge("engine_kv_route", 1.0,
                           {**self._labels, "route": route})

    # -- disaggregated roles (engine/roles.py) --------------------------

    def gauge_role_occupancy(self, role: str, occupancy: float) -> None:
        # engine_role, not role: the bare label is reserved for the
        # cross-process aggregator's proc/role stamp (obs/ship.py).
        self.metrics.gauge("engine_role_occupancy", float(occupancy),
                           {**self._labels, "engine_role": role or "both"})

    def on_handoff(self, blocks: int, wait_s: float) -> None:
        """One prefill→decode KV handoff completed: ``blocks`` pool
        blocks moved, ``wait_s`` between prefill-ready and
        decode-admit (the DisaggregatedEngine wrapper drives this)."""
        m, lb = self.metrics, self._labels
        m.increment("engine_role_handoff_blocks_total", float(blocks),
                    lb)
        m.observe("engine_role_handoff_wait_seconds", float(wait_s),
                  lb)

    # -- durable request journal (engine/journal.py) --------------------

    def gauge_journal(self, depth: int, checkpoint_lag: int) -> None:
        m, lb = self.metrics, self._labels
        m.gauge("engine_journal_depth", float(depth), lb)
        m.gauge("engine_journal_checkpoint_lag", float(checkpoint_lag),
                lb)

    def on_journal_replayed(self, n: int = 1) -> None:
        self.metrics.increment("engine_journal_replayed_total",
                               float(n), self._labels)

    def update_ledgers(self, prefix_stats: dict | None = None,
                       spec_stats: dict | None = None) -> None:
        """Export the engine's existing ledgers (prefix_stats /
        spec_stats) as gauges. Called at retire cadence — the ledgers
        are cumulative, so per-step export buys nothing."""
        m, lb = self.metrics, self._labels
        if prefix_stats and prefix_stats.get("enabled"):
            m.gauge("engine_prefix_hit_rate",
                    float(prefix_stats.get("hit_rate", 0.0)), lb)
        if spec_stats and spec_stats.get("enabled"):
            m.gauge("engine_spec_acceptance_rate",
                    float(spec_stats.get("acceptance_rate", 0.0)), lb)
            m.gauge("engine_spec_draft_hit_rate",
                    float(spec_stats.get("draft_hit_rate", 0.0)), lb)
            m.gauge("engine_tokens_per_weight_pass",
                    float(spec_stats.get("tokens_per_weight_pass",
                                         0.0)), lb)

    # -- summaries ------------------------------------------------------

    def in_flight(self) -> list[RequestTrace]:
        return list(self._traces.values())

    def correlation_ids(self) -> list[str]:
        """Correlation ids of the requests in flight (error reports)."""
        return [t.correlation_id for t in self._traces.values()
                if t.correlation_id]

    def latency_summary(self, last_n: int | None = None) -> dict:
        """Percentile summary over the last ``last_n`` completed
        requests (None = all retained) plus mean occupancy over the
        recorded decode-path steps — the bench's telemetry columns."""
        traces = list(self.completed)
        if last_n is not None:
            traces = traces[-last_n:]
        ttfts = sorted(t.ttft_s for t in traces)
        itls = sorted(t.itl_s for t in traces if t.new_tokens > 1)

        def pct(sorted_vals: list[float], q: float) -> float:
            if not sorted_vals:
                return 0.0
            i = min(len(sorted_vals) - 1,
                    max(0, round(q * (len(sorted_vals) - 1))))
            return sorted_vals[i]

        decode_steps = [r for r in self.recorder.records()
                        if r.kind in ("decode", "verify", "piggyback")
                        and r.batch]
        if last_n is not None and traces:
            # occupancy must describe the same window the percentiles
            # do: drop steps older than the oldest counted request
            # (warmup dispatches would otherwise depress the mean)
            cutoff = min(t.enqueued_wall for t in traces)
            decode_steps = [r for r in decode_steps
                            if r.t_wall >= cutoff]
        occ = (sum(r.occupancy for r in decode_steps) / len(decode_steps)
               if decode_steps else 0.0)
        return {
            "requests": len(traces),
            "ttft_p50_s": round(pct(ttfts, 0.50), 6),
            "ttft_p95_s": round(pct(ttfts, 0.95), 6),
            "ttft_p99_s": round(pct(ttfts, 0.99), 6),
            "itl_mean_s": round(sum(itls) / len(itls), 6) if itls
            else 0.0,
            "itl_p95_s": round(pct(itls, 0.95), 6),
            "mean_occupancy": round(occ, 4),
        }

    # -- flight-recorder dump -------------------------------------------

    def dump(self, *, error: BaseException | None = None,
             extra: dict | None = None) -> dict:
        """The post-mortem record: ring buffer + spans, JSON-ready."""
        out = {
            "engine": self.engine_label,
            "created_wall": self.created_wall,
            "dumped_wall": time.time(),
            "num_slots": self.num_slots,
            "errors": self.errors,
            "in_flight": [t.as_dict() for t in self.in_flight()],
            "correlation_ids": self.correlation_ids(),
            "completed_tail": [t.as_dict()
                               for t in list(self.completed)[-64:]],
            "steps": self.recorder.as_dicts(),
            "summary": self.latency_summary(),
        }
        if error is not None:
            out["error"] = {"type": type(error).__name__,
                            "message": str(error)}
        if extra:
            out.update(extra)
        return out

    def abandon_in_flight(self, finish_reason: str = "error"
                          ) -> list[RequestTrace]:
        """Close every in-flight span: a failed dispatch killed those
        requests, and a long-lived engine that keeps serving after the
        error (the async runner's containment) must not accumulate
        dead spans in ``_traces`` forever — nor should the NEXT
        post-mortem list them as "in flight". Counted in
        ``engine_requests_total{finish_reason="error"}`` but kept OUT
        of the latency histograms (an aborted request has no honest
        e2e latency)."""
        now = time.monotonic()
        out = []
        for rid in list(self._traces):
            tr = self._traces.pop(rid)
            tr.finished_at = now
            tr.finish_reason = finish_reason
            tr.e2e_s = now - tr.enqueued_at
            self.completed.append(tr)
            self.metrics.increment(
                "engine_requests_total", 1.0,
                {**self._labels, "finish_reason": finish_reason})
            out.append(tr)
        return out

    def dump_to_file(self, directory: str | None = None,
                     tag: str = "flight",
                     error: BaseException | None = None,
                     data: dict | None = None) -> str:
        """Write ``data`` (or a fresh ``dump(error=...)``) as JSON.
        The filename counter is local — burning flight-recorder step
        ids on filenames would leave holes in the Perfetto step-id
        sequence."""
        directory = directory or self.dump_dir or _default_dump_dir
        if not directory:
            raise ValueError("no flight-record dump directory configured")
        path = pathlib.Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        self._dump_seq += 1
        fname = (f"{tag}-{self.engine_label}-"
                 f"{int(time.time())}-{self._dump_seq}.json")
        target = path / fname
        if data is None:
            data = self.dump(error=error)
        target.write_text(json.dumps(data, indent=2, default=str))
        return str(target)

    def record_error(self, exc: BaseException,
                     context: dict[str, Any] | None = None
                     ) -> dict:
        """Engine dispatch failed: count it and auto-dump the flight
        recorder (to the configured dir when one is set — a post-mortem
        must not depend on someone remembering to ask). The in-flight
        spans are named in the dump, then closed with
        finish_reason="error" (see ``abandon_in_flight``). Returns the
        dump dict with ``dump_path`` when a file was written, so error
        reporters can attach it."""
        self.errors += 1
        self.metrics.increment("engine_errors_total", 1.0, self._labels)
        dump = self.dump(error=exc, extra=dict(context or {}))
        directory = self.dump_dir or _default_dump_dir
        if directory:
            try:
                dump["dump_path"] = self.dump_to_file(
                    directory=directory, tag="error", data=dump)
            except Exception:
                pass   # the dump must never mask the engine error
        self.abandon_in_flight()
        return dump


def attach_service_collector(holder: Any, metrics,
                             attrs: tuple[str, ...] = ("engine",
                                                       "long_engine",
                                                       "_engine")
                             ) -> int:
    """Production wiring: re-point every engine telemetry hanging off
    ``holder`` (a summarizer / embedding provider) at the SERVICE's
    shared collector — the one the gateway's ``/metrics`` serves.
    Without this the engines' default per-engine collectors render
    beautifully in tests and never reach a scrape in production, which
    is precisely the references-a-series-nobody-emits rot the contract
    tests exist to prevent.

    Only re-points onto an ``InMemoryMetrics``-family collector
    (Pushgateway included): swapping in a Noop would silently discard
    the engines' own renderable copy. Returns how many telemetries
    were re-pointed."""
    if not isinstance(metrics, InMemoryMetrics):
        return 0
    n = 0
    for attr in attrs:
        eng = getattr(holder, attr, None)
        tele = getattr(eng, "telemetry", None)
        if isinstance(tele, EngineTelemetry) and tele.metrics is not \
                metrics:
            tele.metrics = metrics
            n += 1
    return n


def resolve_telemetry(telemetry, *, engine: str, num_slots: int = 0
                      ) -> EngineTelemetry | None:
    """One place for the engines' ``telemetry=`` argument semantics:
    True (the default) builds a fresh recorder, False/None disables,
    an ``EngineTelemetry`` instance is used as-is (shared collector),
    a ``MetricsCollector`` builds a recorder exporting into it."""
    if telemetry is True:
        return EngineTelemetry(engine=engine, num_slots=num_slots)
    if not telemetry:
        return None
    if isinstance(telemetry, EngineTelemetry):
        return telemetry
    if isinstance(telemetry, MetricsCollector):
        return EngineTelemetry(engine=engine, num_slots=num_slots,
                               metrics=telemetry)
    raise ValueError(
        f"telemetry must be bool, EngineTelemetry or MetricsCollector, "
        f"got {type(telemetry).__name__}")
