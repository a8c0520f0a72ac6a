"""Pipeline wiring: all services on one bus, config-driven.

The single-process equivalent of the reference's docker-compose stack —
its fake-backend strategy (SURVEY.md §4) made the full pipeline runnable
with zero infra; this runner is that mode as a first-class object, and
the production mode just swaps drivers via config (zmq bus, sqlite store,
tpu engines) without touching service code.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.bus.inproc import (
    InProcBroker,
    InProcPublisher,
    InProcSubscriber,
)
from copilot_for_consensus_tpu_torch.bus.validating import ValidatingPublisher
from copilot_for_consensus_tpu_torch.consensus.base import create_consensus_detector
from copilot_for_consensus_tpu_torch.core.retry import RetryConfig, RetryPolicy
from copilot_for_consensus_tpu_torch.embedding.factory import (
    create_embedding_provider,
)
from copilot_for_consensus_tpu_torch.fetch.base import LocalFetcher, MockFetcher
from copilot_for_consensus_tpu_torch.archive.base import InMemoryArchiveStore
from copilot_for_consensus_tpu_torch.obs.logging import SilentLogger
from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics
from copilot_for_consensus_tpu_torch.services.chunking import ChunkingService
from copilot_for_consensus_tpu_torch.services.embedding import EmbeddingService
from copilot_for_consensus_tpu_torch.services.ingestion import IngestionService
from copilot_for_consensus_tpu_torch.services.orchestrator import (
    ContextSelector,
    OrchestrationService,
)
from copilot_for_consensus_tpu_torch.services.parsing import ParsingService
from copilot_for_consensus_tpu_torch.services.reporting import ReportingService
from copilot_for_consensus_tpu_torch.services.summarization import (
    SummarizationService,
)
from copilot_for_consensus_tpu_torch.storage.factory import create_document_store
from copilot_for_consensus_tpu_torch.summarization.factory import create_summarizer
from copilot_for_consensus_tpu_torch.text.chunkers import TokenWindowChunker
from copilot_for_consensus_tpu_torch.vectorstore.factory import create_vector_store


@dataclass
class Pipeline:
    broker: InProcBroker
    store: Any
    vector_store: Any
    ingestion: IngestionService
    parsing: Any
    chunking: ChunkingService
    embedding: EmbeddingService
    orchestrator: OrchestrationService
    summarization: SummarizationService
    reporting: ReportingService
    metrics: InMemoryMetrics
    subscribers: list = field(default_factory=list)
    # Populated when cfg["bus"] names an inter-process driver: one durable
    # subscriber PER WORKER per service (all sharing the service's queue
    # group, so they compete for messages like the reference's replica
    # containers), consuming the external broker directly so ack happens
    # only after the handler returns — crash before ack ⇒ lease expiry ⇒
    # redelivery.
    ext_subscribers: list = field(default_factory=list)
    # One StageWorkerPool per owned service on the external-bus tier
    # (services/pool.py): owns that service's worker subscribers and
    # their stop-aware consume threads. cfg["services"][<name>]
    # ["workers"] sizes each pool (default 1).
    worker_pools: list = field(default_factory=list)
    # Service names this process consumes bus events for (cfg["roles"]);
    # None = all. Other services still exist for their REST/read surface
    # — their events flow to whichever process owns the role.
    roles: frozenset | None = None
    # One shared FaultBoundary (bus/faults.py) when cfg["faults"] scripts
    # a pipeline fault plan: the same plan fires across bus publish/
    # fetch/ack and the store wrappers, so a chaos phase faults every
    # boundary coherently. None in production.
    fault_boundary: Any = None
    _seen_gauge_keys: set = field(default_factory=set)
    _seen_count_keys: set = field(default_factory=set)

    @property
    def services(self):
        return (self.ingestion, self.parsing, self.chunking, self.embedding,
                self.orchestrator, self.summarization, self.reporting)

    @property
    def owned_services(self):
        if self.roles is None:
            return self.services
        return tuple(s for s in self.services if s.name in self.roles)

    def startup(self) -> None:
        # Startup requeue stays role-scoped: each process re-publishes
        # only the stuck documents of stages it consumes.
        for svc in self.owned_services:
            svc.startup()

    def drain(self, max_messages: int | None = None) -> int:
        """Dispatch up to ``max_messages`` queued events (unbounded when
        None) until quiescent. With an external bus, round-robin the
        per-service durable subscribers against one shared budget.

        A pipelined summarization service keeps generations in flight
        after the bus looks empty; quiescence then means "bus drained
        AND nothing in flight" — their completions publish follow-up
        events this loop must also dispatch."""
        summ = self.summarization
        # The in-flight wait applies only to UNBOUNDED drains: a caller
        # asking for max_messages wants bounded stepping, not
        # run-to-quiescence.
        await_flight = (max_messages is None
                        and getattr(summ, "pipelined", False))
        if not self.ext_subscribers:
            handled = self.broker.drain(max_messages)
            while await_flight:
                if summ.in_flight:
                    summ.flush()
                n = self.broker.drain(None)
                handled += n
                if not summ.in_flight and n == 0:
                    break       # bus empty AND nothing generating
            return handled
        n = 0
        while max_messages is None or n < max_messages:
            budget = None if max_messages is None else max_messages - n
            handled = 0
            for sub in self.ext_subscribers:
                handled += sub.drain(budget if budget is None
                                     else budget - handled)
                if budget is not None and handled >= budget:
                    break
            n += handled
            if not handled:
                # Quiescence must include in-flight generations: their
                # completions publish events this loop still has to
                # dispatch (same contract as the in-proc branch).
                if await_flight and summ.in_flight:
                    summ.flush()
                    continue
                break
        return n

    def routing_key_depths(self) -> dict[str, int]:
        """Per-key backlog for the bus gauges — from the external broker
        when one is configured (that's where the real queues live),
        in-proc otherwise. Dead letters surface as ``<rk>.dlq``. Keys
        previously reported but now fully drained (acked rows delete, so
        counts() omits them) are re-emitted as 0 so gauges don't stick
        at their last backlog value."""
        if not self.ext_subscribers:
            return self.broker.routing_key_depths()
        out: dict[str, int] = dict.fromkeys(self._seen_gauge_keys, 0)
        for rk, states in self.ext_subscribers[0].counts(
                timeout_ms=1500).items():
            out[rk] = states.get("pending", 0) + states.get("inflight", 0)
            if states.get("dead"):
                out[f"{rk}.dlq"] = states["dead"]
        self._seen_gauge_keys.update(out)
        return out

    def bus_counts(self) -> dict[str, dict[str, int]]:
        """Per-key ``{"pending", "inflight", "dead", "parked"}`` — the
        broker's ``counts()`` split, the source for the
        ``copilot_bus_pending``/``inflight``/``dead``/``parked`` gauges
        and the chaos gate's final-depth assertion (which reads
        pending+inflight only: parked rows are pre-bind retention, not
        consumer backlog). Keys previously reported but since drained
        re-emit as zeros (same stickiness rule as
        ``routing_key_depths``). Best-effort: an unreachable broker
        returns {}."""
        def entry() -> dict[str, int]:
            return {"pending": 0, "inflight": 0, "dead": 0, "parked": 0}

        out = {rk: entry() for rk in self._seen_count_keys}
        if self.ext_subscribers:
            try:
                counts = self.ext_subscribers[0].counts(timeout_ms=1500)
            except Exception:
                return {}
            for rk, states in counts.items():
                out[rk] = {k: int(states.get(k, 0))
                           for k in ("pending", "inflight", "dead",
                                     "parked")}
        else:
            for rk, d in self.broker.routing_key_depths().items():
                out.setdefault(rk, entry())["pending"] = d
            for rk, _env in self.broker.dead_lettered:
                out.setdefault(rk, entry())["dead"] += 1
        self._seen_count_keys.update(out)
        return out

    def publisher_stats(self) -> dict[str, int]:
        """Aggregate publish-outbox ledger across every service's
        publisher (``BrokerPublisher.outbox_stats``; drivers without an
        outbox contribute nothing) — the ride-through evidence the
        gauges and the chaos artifact report."""
        total = {"confirmed": 0, "parked": 0, "replayed": 0,
                 "overflow": 0, "throttle_waits": 0, "outbox_depth": 0}
        for svc in self.services:
            fn = getattr(svc.publisher, "outbox_stats", None)
            if not callable(fn):
                continue
            for k, v in fn().items():
                total[k] = total.get(k, 0) + int(v)
        return total

    def stop_throttling(self) -> None:
        """Release every service's backpressure pause (and any
        in-progress ingestion pacing wait): shutdown must never wait
        out a watermark."""
        for svc in self.services:
            svc.stop_throttling()

    def stop_consuming(self, timeout: float = 5.0) -> bool:
        """Graceful-drain step 2 (services/lifecycle.py): release any
        backpressure wait, then stop-and-join every worker pool. Each
        worker finishes (and acks) its in-flight dispatch before
        exiting — nothing is nacked by shutdown itself, so unfetched
        messages simply stay pending and the broker redelivers nothing
        after a clean drain. Returns False when a worker failed to
        join (pool.stop logs the stuck dispatch state)."""
        self.stop_throttling()
        # Flip EVERY pool's stop flags first, THEN join against one
        # shared deadline: sequential stop-and-join would bound this
        # step at n_pools x timeout — two slow pools would blow the
        # drain deadline (and the container's stop grace period)
        # before the engine ever got to checkpoint.
        for pool in self.worker_pools:
            for sub in pool.subscribers:
                sub.stop()
        deadline = time.monotonic() + timeout
        ok = True
        for pool in self.worker_pools:
            ok = pool.stop(timeout=max(
                0.0, deadline - time.monotonic())) and ok
        return ok

    def drain_engines(self, deadline_s: float = 30.0) -> dict:
        """Graceful-drain step 3: let engine-backed drivers finish
        their active slots up to ``deadline_s``, then evacuate-and-
        journal the remainder (engine/journal.py). Duck-typed on a
        driver ``drain(deadline_s)`` method — TPUSummarizer implements
        it; mock drivers have nothing in flight. Returns per-service
        ``{name: fully_drained}``."""
        out: dict[str, bool] = {}
        # ONE shared deadline across drainers (the stop_consuming
        # discipline): handing each the full budget sequentially would
        # bound this step at n_drainers x deadline and blow the
        # container's stop grace period before the outbox ever flushed
        deadline = time.monotonic() + deadline_s
        for name, obj in (
                ("summarization",
                 getattr(self.summarization, "summarizer", None)),
                ("embedding",
                 getattr(self.embedding, "provider", None))):
            fn = getattr(obj, "drain", None)
            if callable(fn):
                try:
                    out[name] = bool(fn(max(
                        0.0, deadline - time.monotonic())))
                except Exception:
                    out[name] = False
        return out

    def flush_outboxes(self, timeout_s: float = 10.0,
                       stop: "threading.Event | None" = None) -> bool:
        """Graceful-drain step 4: wait for every publisher's durable
        outbox to replay to the broker. True when all outboxes reached
        depth 0 within the budget; rows survive on disk either way
        when the outbox is durable. Pass ``stop`` to make the wait
        abortable (an aborted drain returns to READY); without one the
        poll simply runs out its deadline."""
        if stop is None:
            stop = threading.Event()
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                depth = self.publisher_stats().get("outbox_depth", 0)
            except Exception:
                # unreadable is NOT flushed: keep polling and report
                # False if it never becomes readable — the drain
                # report must not claim a clean flush it cannot see
                depth = None
            if depth == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            if stop.wait(0.05):
                return False

    def degraded(self) -> list[str]:
        """Degraded-but-alive conditions for the /health body (the
        readyz 503 is the lifecycle's call; this is operator signal):
        open supervisor breakers, a suspect or unhealthy engine, and a
        journal backlog on an idle engine. Best-effort duck-typing —
        mock drivers report nothing."""
        out: list[str] = []
        summ = getattr(self.summarization, "summarizer", None)
        runner = getattr(summ, "_runner", None)
        sup = getattr(runner, "supervisor", None)
        if sup is not None:
            for b in (sup.verify_breaker, sup.resource_breaker):
                if b.state != "closed":
                    out.append(f"engine-breaker:{b.name}:{b.state}")
            if sup.suspect:
                out.append("engine-suspect")
            if sup.unhealthy:
                out.append("engine-unhealthy")
        eng = getattr(summ, "engine", None)
        j = getattr(eng, "journal", None)
        if j is not None and runner is None:
            # a journal depth with no dispatcher running means
            # recovered work is parked and nothing will serve it
            try:
                if j.depth():
                    out.append("engine-journal-backlog")
            except Exception:
                pass
        return out

    def run_forever(self, stop) -> None:
        """Blocking pump for server mode: in-proc dispatch, or (external
        bus) one StageWorkerPool per service — N stop-aware consume
        loops each, every loop already surviving broker outages with
        backoff-and-reconnect. Teardown stops-and-joins every pool;
        a worker that outlives the join is logged with its current
        dispatch state by ``StageWorkerPool.stop`` (never silently
        abandoned)."""
        if not self.ext_subscribers:
            return self.broker.run_forever(stop)
        for pool in self.worker_pools:
            pool.start()
        try:
            stop.wait()
        finally:
            self.stop_consuming()

    def ingest_and_run(self, source_id: str) -> dict[str, int]:
        """Trigger a source, run the pipeline to quiescence, return
        document counts — the one-call end-to-end path."""
        self.ingestion.trigger_source(source_id)
        self.drain()
        return self.reporting.stats()


def build_pipeline(config: Mapping[str, Any] | None = None) -> Pipeline:
    """Wire every service onto one bus.

    config keys (all optional): ``document_store``, ``vector_store``,
    ``embedding``, ``llm``, ``chunking``, ``orchestrator``,
    ``summarization`` — each a driver-config mapping; ``bus`` selects
    the inter-process broker; ``roles`` (list of service names) scopes
    which stages THIS process consumes — the role-per-container split of
    the reference's docker-compose.services.yml, and the host/TPU-slice
    split of SURVEY §7 (host stages with mock engine drivers in one
    process, embedding+orchestrator+summarization with TPU drivers in
    the engine process).
    """
    cfg = dict(config or {})
    # Validate roles FIRST: a typo must fail before checkpoints load and
    # stores connect, and role-scoping only works over an inter-process
    # bus — on a private in-proc broker the unowned stages' events would
    # park forever while drain() reports quiescent.
    roles = cfg.get("roles")
    if roles is not None:
        known = {IngestionService.name, ParsingService.name,
                 ChunkingService.name, EmbeddingService.name,
                 OrchestrationService.name, SummarizationService.name,
                 ReportingService.name}
        bad = set(roles) - known
        if bad:
            raise ValueError(f"unknown roles {sorted(bad)}; "
                             f"known: {sorted(known)}")
        if not roles:
            raise ValueError(
                "roles=[] would consume nothing; omit the key to consume "
                "every stage")
        if dict(cfg.get("bus") or {}).get("driver", "inproc") not in (
                "broker", "zmq"):
            raise ValueError(
                "roles requires an inter-process bus (bus.driver broker); "
                "on the in-proc bus unowned stages' events would never "
                "be consumed")
        # Same silent-split hazard for state: with a defaulted private
        # in-memory store, the other role's process would look up ids in
        # its own empty store and DLQ every event. Tests that rewire
        # store objects across in-process "roles" opt out explicitly.
        if not cfg.get("unsafe_private_stores"):
            # ingestion writes archive BYTES that parsing reads; when
            # the two live in different processes a private in-memory
            # archive store leaves parsing reading nothing and every
            # archive event dead-letters (found driving the broker-path
            # scale bench).
            has_ing = IngestionService.name in roles
            has_par = ParsingService.name in roles
            arch_driver = dict(cfg.get("archive_store")
                               or {}).get("driver", "memory")
            if has_ing != has_par and arch_driver == "memory":
                raise ValueError(
                    "roles split ingestion and parsing across processes "
                    "but the archive_store driver is private in-memory; "
                    "configure a shared one (e.g. {'driver': 'document'} "
                    "to ride the shared document store)")
            for section, default_driver in (("document_store", "memory"),
                                            ("vector_store", "memory")):
                sec = dict(cfg.get(section) or {})
                driver = sec.get("driver", default_driver)
                # sqlite ":memory:" is equally private (one db per
                # connection — sqlite.py holds one per thread).
                if driver == "memory" or (driver == "sqlite" and
                                          sec.get("path") == ":memory:"):
                    raise ValueError(
                        f"roles requires a shared {section} (e.g. sqlite "
                        f"on a shared volume): a private in-memory "
                        f"{section} would leave the peer process reading "
                        f"empty state (set unsafe_private_stores to "
                        f"override in tests)")
    broker = InProcBroker()
    # Scripted pipeline fault plane (bus/faults.py): cfg["faults"] is a
    # FaultPlan dict (optionally {"plan": ..., "terminal_kinds": [...]})
    # shared across bus and storage boundaries — the chaos harness's
    # config surface, absent in production.
    fault_boundary = None
    if cfg.get("faults"):
        from copilot_for_consensus_tpu_torch.bus.faults import (
            FaultPlan,
            resolve_boundary,
        )

        fcfg = dict(cfg["faults"])
        plan = fcfg.get("plan", fcfg)
        fault_boundary = resolve_boundary(
            FaultPlan.from_dict(dict(plan)),
            terminal_kinds=tuple(fcfg.get("terminal_kinds", ())))
    store = create_document_store(cfg.get("document_store",
                                          {"driver": "memory"}))
    store.connect()
    vector_store = create_vector_store(cfg.get("vector_store",
                                               {"driver": "memory"}))
    vector_store.connect()
    if fault_boundary is not None:
        from copilot_for_consensus_tpu_torch.bus.faults import (
            FaultingDocumentStore,
            FaultingVectorStore,
        )

        store = FaultingDocumentStore(store, fault_boundary)
        vector_store = FaultingVectorStore(vector_store, fault_boundary)
    # Distributed-tracing child spans (obs/trace.py): store writes and
    # vector upserts record under the dispatching stage span. Outside a
    # trace (no ambient span) the wrappers are pure passthrough, and
    # they wrap OUTSIDE the fault plane so an injected store fault shows
    # up as an error-status child span in the trace.
    from copilot_for_consensus_tpu_torch.obs.trace import (
        TracingDocumentStore,
        TracingVectorStore,
    )

    store = TracingDocumentStore(store)
    vector_store = TracingVectorStore(vector_store)
    provider = create_embedding_provider(cfg.get("embedding",
                                                 {"driver": "mock"}))
    summarizer = create_summarizer(cfg.get("llm", {"driver": "mock"}))
    consensus = create_consensus_detector(
        cfg.get("consensus", {"driver": "heuristic"}))
    if cfg.get("metrics"):
        # e.g. {"driver": "pushgateway", "gateway_url": ...} — without
        # this the config key would be dead and push semantics silently
        # unavailable to the pipeline process.
        from copilot_for_consensus_tpu_torch.obs.metrics import (
            create_metrics_collector,
        )

        metrics = create_metrics_collector(cfg["metrics"])
    else:
        metrics = InMemoryMetrics()
    # Retrieval telemetry: the store emits vectorstore_query_* series
    # into the same collector the services use. set_metrics forwards
    # through the tracing/fault wrappers (__getattr__ passthrough);
    # drivers without native metrics inherit the base no-op.
    vector_store.set_metrics(metrics)
    if cfg.get("logger"):
        # e.g. {"driver": "shipping", "host": "logstore", "port": 5140}
        # — tees JSON records to the logstore so "query by correlation
        # id" has a backend in multi-process deployments.
        from copilot_for_consensus_tpu_torch.obs.logging import create_logger

        logger = create_logger(cfg["logger"])
    else:
        logger = SilentLogger() if not cfg.get("verbose") else None
    if cfg.get("archive_store"):
        # Role-split processes need a SHARED archive store (the parsing
        # worker reads bytes the ingestion process stored): e.g.
        # {"driver": "document"} rides the shared document store, or
        # {"driver": "local", "root": ...} a shared volume.
        from copilot_for_consensus_tpu_torch.archive.base import (
            create_archive_store,
        )

        archive_store = create_archive_store(dict(cfg["archive_store"]),
                                             document_store=store)
    else:
        archive_store = InMemoryArchiveStore()
    if fault_boundary is not None:
        from copilot_for_consensus_tpu_torch.bus.faults import (
            FaultingArchiveStore,
        )

        archive_store = FaultingArchiveStore(archive_store,
                                             fault_boundary)
    retry = RetryPolicy(RetryConfig(max_attempts=3, base_delay=0.01,
                                    max_delay=0.05))

    # With an inter-process bus configured, the external durable broker IS
    # the bus: services publish to it and consume from it directly (one
    # group per service), so competing pipeline replicas share work and a
    # crash before ack redelivers (reference semantics:
    # rabbitmq_publisher.py:146-149 / rabbitmq_subscriber.py:504-560).
    bus_cfg = dict(cfg.get("bus") or {})
    ext_bus = bus_cfg.get("driver", "inproc") in ("broker", "zmq")

    def publisher() -> ValidatingPublisher:
        if ext_bus:
            from copilot_for_consensus_tpu_torch.bus.factory import (
                create_publisher,
            )

            return create_publisher(bus_cfg, faults=fault_boundary)
        # the watermark saturation surface works on either tier
        return ValidatingPublisher(InProcPublisher(
            config={"high_watermark": bus_cfg.get("high_watermark", 0)},
            broker=broker))

    common = dict(logger=logger, metrics=metrics, retry=retry)
    ingestion = IngestionService(
        publisher(), store, archive_store,
        fetchers={"local": LocalFetcher(),
                  "mock": cfg.get("mock_fetcher") or MockFetcher()},
        # Ingest pacing rides the same watermark as the publishers'
        # depth backpressure: one knob (bus.high_watermark) bounds the
        # whole pipeline's queue depths.
        bus_watermark=int(bus_cfg.get("high_watermark", 0) or 0),
        **common)
    parsing = ParsingService(publisher(), store, archive_store, **common)
    chunking = ChunkingService(
        publisher(), store,
        chunker=TokenWindowChunker(**cfg.get("chunking", {})), **common)
    # Scheduling identity (engine/scheduler.py): deployment config names
    # the tenant/priority this pipeline's engine traffic runs under, so
    # a multi-tenant serving deployment can weight/quota it (and shed it
    # honestly) against interactive traffic.
    tenancy = dict(cfg.get("tenancy") or {})
    embedding = EmbeddingService(publisher(), store, provider, vector_store,
                                 tenant=str(tenancy.get("tenant", "")),
                                 **common)
    orch_cfg = cfg.get("orchestrator", {})
    orchestrator = OrchestrationService(
        publisher(), store, vector_store=vector_store,
        embedding_provider=provider,
        selector=ContextSelector(
            top_k=int(orch_cfg.get("top_k", 12)),
            context_window_tokens=int(
                orch_cfg.get("context_window_tokens", 3000))),
        **common)
    summarization = SummarizationService(
        publisher(), store, summarizer, consensus_detector=consensus,
        pipelined=bool(dict(cfg.get("llm") or {}).get("pipelined")),
        tenant=str(tenancy.get("tenant", "")),
        priority=str(tenancy.get("priority", "")),
        **common)
    reporting = ReportingService(
        publisher(), store,
        webhook_url=cfg.get("webhook_url", ""),
        webhook_sender=cfg.get("webhook_sender"),
        embedding_provider=provider, vector_store=vector_store, **common)

    pipeline = Pipeline(
        broker=broker, store=store, vector_store=vector_store,
        ingestion=ingestion, parsing=parsing, chunking=chunking,
        embedding=embedding, orchestrator=orchestrator,
        summarization=summarization, reporting=reporting, metrics=metrics,
        roles=frozenset(roles) if roles is not None else None,
        fault_boundary=fault_boundary)

    # Stage scale-out config: cfg["services"][<name>] maps per-service
    # knobs — "workers" (pool size, default 1), "prefetch" (per-fetch
    # lease batch, overriding bus.prefetch), "batch" (False disables
    # wave dispatch for services that define one). ROADMAP item 4: this
    # is where service concurrency decouples from broker semantics.
    services_cfg = {str(k): dict(v or {})
                    for k, v in dict(cfg.get("services") or {}).items()}
    known_services = {s.name for s in pipeline.services}
    bad_services = set(services_cfg) - known_services
    if bad_services:
        raise ValueError(f"unknown services config keys "
                         f"{sorted(bad_services)}; known: "
                         f"{sorted(known_services)}")
    for svc in pipeline.owned_services:
        # One queue group per service: fan-out across services (every
        # stage sees SourceDeletionRequested), competition within one.
        # Same topology on either tier; validation wraps the edge so
        # malformed foreign envelopes quarantine instead of crashing
        # handlers into the DLQ.
        opts = services_cfg.get(svc.name, {})
        if ext_bus:
            from copilot_for_consensus_tpu_torch.bus.factory import (
                create_subscriber,
            )
            from copilot_for_consensus_tpu_torch.services.pool import (
                StageWorkerPool,
            )

            workers = max(1, int(opts.get("workers", 1)))
            sub_cfg = {**bus_cfg, "group": svc.name}
            if "prefetch" in opts:
                sub_cfg["prefetch"] = int(opts["prefetch"])
            wave_keys = (svc.wave_routing_keys()
                         if opts.get("batch", True) else [])
            subs = []
            for _w in range(workers):
                sub = create_subscriber(dict(sub_cfg),
                                        faults=fault_boundary)
                # Drivers with consumer-side counters/logs (broker
                # dispatch failures, the servicebus bus_misroute_dropped
                # guard) share the pipeline's collector — set on the
                # INNER driver: assigning through the validating wrapper
                # would only shadow the attribute on the wrapper itself.
                inner = getattr(sub, "inner", sub)
                if hasattr(inner, "metrics"):
                    inner.metrics = pipeline.metrics
                if hasattr(inner, "logger") and svc.logger is not None:
                    inner.logger = svc.logger
                sub.subscribe(svc.routing_keys(), svc.handle_envelope)
                if wave_keys:
                    # opt-in batch dispatch: fetch waves of these keys
                    # go through the service's handle_envelopes hot
                    # path; drivers without batch support return False
                    # and stay per-envelope
                    sub.subscribe_batch(wave_keys, svc.handle_envelopes)
                subs.append(sub)
                pipeline.ext_subscribers.append(sub)
            pipeline.worker_pools.append(
                StageWorkerPool(svc.name, subs, logger=svc.logger))
        else:
            sub = InProcSubscriber(broker=broker, group=svc.name)
            sub.subscribe(svc.routing_keys(), svc.handle_envelope)
            pipeline.subscribers.append(sub)
    return pipeline
