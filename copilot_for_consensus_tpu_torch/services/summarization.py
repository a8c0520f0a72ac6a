"""Summarization service: execute LLM summarization of selected context.

Reference behaviors kept (``summarization/app/service.py:199``):
* context strictly from the orchestrator's pre-selected chunks (``:545``),
* citations derived from chunks, not LLM output (``:291-307``),
* deterministic summary id (``:741``) → idempotent storage,
* rate-limit-aware retry (``:367-402``).
Plus consensus annotation: the detector (heuristic or embedding-ML) runs
over the thread's messages and its signal is stored with the summary —
the capability the reference's ``copilot_consensus`` package is building
toward.
"""

from __future__ import annotations

import contextlib
import time
from datetime import datetime, timezone

from copilot_for_consensus_tpu_torch.consensus.base import ConsensusDetector
from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.retry import (
    DocumentNotFoundError,
    RetryableError,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import EngineOverloaded
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    EngineFailed,
    EngineSuspect,
)
from copilot_for_consensus_tpu_torch.obs import trace
from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.summarization.base import (
    RateLimitError,
    Summarizer,
    ThreadContext,
)


class SummarizationService(BaseService):
    name = "summarization"
    consumes = ("SummarizationRequested",)

    def __init__(self, publisher, store, summarizer: Summarizer,
                 consensus_detector: ConsensusDetector | None = None,
                 context_window_tokens: int = 4096,
                 pipelined: bool = False, tenant: str = "",
                 priority: str = "", **kw):
        super().__init__(publisher, store, **kw)
        self.summarizer = summarizer
        self.consensus_detector = consensus_detector
        self.context_window_tokens = context_window_tokens
        # Multi-tenant scheduling (engine/scheduler.py): this service
        # instance's requests carry these keys into the engine's
        # fairness/shedding policy. Deployment config decides — e.g.
        # the pipeline's bulk re-summarization runs as a "batch"-lane
        # tenant so interactive traffic preempts it.
        self.tenant = tenant
        self.priority = priority
        # Pipelined mode: events submit into the engine's continuous
        # batch and return immediately; a harvester thread runs the
        # store/publish tail when each generation lands. This is what
        # keeps the engine's decode slots full when events arrive one at
        # a time — the measured bench_summarize bottleneck (~7 s/thread
        # serialized regardless of slot count). Tradeoff: the bus acks
        # before the summary is durable, so a crash mid-generation
        # relies on the stuck-document retry job / startup requeue (the
        # pipeline's existing recovery spine) instead of redelivery.
        self.pipelined = pipelined and hasattr(summarizer,
                                               "summarize_async")
        # Capability probe ONCE, not per event: which of the optional
        # kwargs (correlation_id, tenant, priority) does
        # summarize_async accept? (services/base.py:accepts_kwargs)
        from copilot_for_consensus_tpu_torch.services.base import (
            accepts_kwargs,
        )

        self._async_kwargs: set[str] = set()
        if self.pipelined:
            self._async_kwargs = accepts_kwargs(
                summarizer.summarize_async,
                ("correlation_id", "tenant", "priority"))
        # Engine flight-recorder wiring (engine/telemetry.py): the
        # engines' copilot_engine_* observations must land on THIS
        # service's collector — the one the gateway /metrics serves —
        # or the serving dashboard/alert pack watches series nobody
        # emits; and an engine dispatch failure must reach the
        # service's error reporter naming its in-flight correlation
        # ids (TPUSummarizer hands the reporter to its AsyncEngineRunner).
        from copilot_for_consensus_tpu_torch.engine.telemetry import (
            attach_service_collector,
        )

        attach_service_collector(summarizer, self.metrics)
        if self.error_reporter is not None and hasattr(summarizer,
                                                       "error_reporter"):
            summarizer.error_reporter = self.error_reporter
        import collections
        import threading

        self._in_flight: "collections.deque" = collections.deque()
        self._flight_lock = threading.Lock()
        self._flight_event = threading.Event()
        self._drained = threading.Condition()
        self._harvester: threading.Thread | None = None

    def on_SummarizationRequested(self,
                                  event: ev.SummarizationRequested) -> None:
        self.process_thread(event.thread_id, event.summary_id,
                            event.selected_chunks, event.context_selection,
                            event.correlation_id)

    # -- pipelined-mode plumbing ---------------------------------------

    @property
    def in_flight(self) -> int:
        with self._flight_lock:
            return len(self._in_flight)

    def flush(self, timeout: float = 600.0) -> None:
        """Block until every in-flight generation has been harvested.

        Waits on the drained condition (signalled by the harvester as
        the queue empties) instead of polling — a 50 Hz poll here is
        host-side GIL noise exactly while the dispatcher is serving."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._drained:
            while self.in_flight:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return
                self._drained.wait(timeout=min(0.5, remaining))

    def _ensure_harvester(self) -> None:
        import threading

        if self._harvester is not None and self._harvester.is_alive():
            return
        self._harvester = threading.Thread(
            target=self._harvest_loop, daemon=True,
            name="summarization-harvest")
        self._harvester.start()

    def _harvest_loop(self) -> None:
        while True:
            self._flight_event.wait(0.2)
            with self._flight_lock:
                item = self._in_flight[0] if self._in_flight else None
                if item is None:
                    self._flight_event.clear()
            if item is None:
                continue
            wait, finalize, ctx = item
            tctx = ctx.get("trace_ctx")
            resume = (trace.use_context(*tctx, service=self.name)
                      if tctx else contextlib.nullcontext())
            with resume:
                # inside the originating trace context: finalize's
                # store writes and the SummaryComplete (or
                # SummarizationFailed) publish stay in its DAG even
                # though they run on the harvester thread
                try:
                    summary = wait()
                    finalize(summary)
                except Exception as exc:   # noqa: BLE001 — must not die
                    self.logger.error(
                        "pipelined summarization failed",
                        thread_id=ctx.get("thread_id", ""),
                        error=f"{type(exc).__name__}: {exc}")
                    try:
                        self.publisher.publish(ev.SummarizationFailed(
                            thread_id=ctx.get("thread_id", ""),
                            summary_id=ctx.get("summary_id", ""),
                            error=str(exc),
                            error_type=type(exc).__name__,
                            attempts=1,
                            correlation_id=ctx.get("correlation_id",
                                                   "")))
                    # the SummarizationFailed publish above IS the
                    # classification; if the bus is down too, dying
                    # here would kill the harvester for every other
                    # in-flight summary
                    except Exception:  # jaxlint: disable=dura-ack-swallow
                        pass
                finally:
                    with self._flight_lock:
                        self._in_flight.popleft()
                        empty = not self._in_flight
                    if empty:
                        with self._drained:
                            self._drained.notify_all()

    def process_thread(self, thread_id: str, summary_id: str,
                       selected_chunks: list[str],
                       context_selection: dict | None = None,
                       correlation_id: str = "") -> str | None:
        if self.store.get_document("summaries", summary_id) is not None:
            return None  # idempotent replay
        thread = self.store.get_document("threads", thread_id)
        if thread is None:
            raise DocumentNotFoundError(f"thread {thread_id} not in store")
        current_id = thread.get("summary_id", "")
        if current_id and current_id != summary_id:
            cur = self.store.get_document("summaries", current_id)
            if cur and set(selected_chunks) <= set(
                    cur.get("chunk_ids", [])):
                # Stale request: at-least-once redelivery can reorder a
                # SummarizationRequested behind a newer one that already
                # summarized a superset of these chunks. The pointer
                # never moves backward — summarizing again would mint a
                # duplicate terminal artifact for less context.
                self.metrics.increment("summarization_stale_total")
                return None
        chunk_docs = self.store.query_documents(
            "chunks", {"chunk_id": {"$in": selected_chunks}})
        if not chunk_docs and selected_chunks:
            raise DocumentNotFoundError("selected chunks not visible yet")
        order = {cid: i for i, cid in enumerate(selected_chunks)}
        chunk_docs.sort(key=lambda d: order.get(d["chunk_id"], 1 << 30))
        scores = (context_selection or {}).get("scores", {})

        context = ThreadContext(
            thread_id=thread_id,
            subject=thread.get("subject", ""),
            participants=thread.get("participants", []),
            message_count=thread.get("message_count", 0),
            chunks=[{
                "chunk_id": d["chunk_id"],
                "message_doc_id": d.get("message_doc_id", ""),
                "text": d.get("text", ""),
                "score": scores.get(d["chunk_id"], 0.0),
            } for d in chunk_docs],
            context_window_tokens=self.context_window_tokens,
        )

        t0 = time.monotonic()
        if self.pipelined:
            # correlation_id / tenant / priority reach the engine's
            # telemetry span and scheduler when the summarizer accepts
            # them (capabilities probed once at construction).
            kw = {}
            if "correlation_id" in self._async_kwargs:
                kw["correlation_id"] = correlation_id
            if self.tenant and "tenant" in self._async_kwargs:
                kw["tenant"] = self.tenant
            if self.priority and "priority" in self._async_kwargs:
                kw["priority"] = self.priority
            try:
                # engine_submit child span: the engine-side
                # RequestTrace joins this trace by correlation_id
                with trace.child_span("engine_submit",
                                      "summarize_async",
                                      service=self.name,
                                      correlation_id=correlation_id):
                    wait = self.summarizer.summarize_async(context, **kw)
            except EngineOverloaded as exc:
                # The scheduler shed this request at the door — an
                # ADMISSION outcome, not an engine failure: no error-
                # reporter dump, just the bus retry policy backing off
                # for the advertised drain time (the same contract as
                # the reference's rate-limit handling below).
                raise RetryableError(
                    f"engine overloaded ({exc.reason}), retry after "
                    f"{exc.retry_after_s:.1f}s") from exc

            def finalize(summary, _t0=t0, _tid=thread_id,
                         _sid=summary_id, _chunks=selected_chunks,
                         _sel=context_selection, _corr=correlation_id):
                self._store_and_publish(summary, _sid, _tid, _chunks,
                                        _sel, _corr,
                                        time.monotonic() - _t0)

            with self._flight_lock:
                self._in_flight.append((wait, finalize, {
                    "thread_id": thread_id, "summary_id": summary_id,
                    "correlation_id": correlation_id,
                    # the harvester thread re-enters this trace so the
                    # store/publish tail (and SummaryComplete) stays in
                    # the originating DAG instead of rooting a new one
                    "trace_ctx": trace.current_ids()}))
            self._flight_event.set()
            self._ensure_harvester()
            return summary_id
        try:
            with trace.child_span("engine_submit", "summarize",
                                  service=self.name,
                                  correlation_id=correlation_id):
                summary = self.summarizer.summarize(context)
        except RateLimitError as exc:
            # Let the retry policy back off (reference ``:367-402``).
            raise RetryableError(
                f"rate limited, retry after {exc.retry_after_s}s") from exc
        except EngineOverloaded as exc:
            # Scheduler shed on the synchronous path: same backoff
            # contract as a rate limit — transient, honest, retryable.
            raise RetryableError(
                f"engine overloaded ({exc.reason}), retry after "
                f"{exc.retry_after_s:.1f}s") from exc
        except (EngineFailed, EngineSuspect) as exc:
            # Supervisor-structured engine failure (replay budget
            # spent / watchdog suspect): the bus retry policy is the
            # outer recovery layer — exactly the broker-redelivery
            # story the reference gets from RabbitMQ when its
            # inference container dies (SURVEY §0). The engine will
            # have recovered (or been replaced) by redelivery time.
            raise RetryableError(
                f"engine failure ({type(exc).__name__}): {exc}"
            ) from exc
        latency = time.monotonic() - t0
        self._store_and_publish(summary, summary_id, thread_id,
                                selected_chunks, context_selection,
                                correlation_id, latency)
        return summary_id

    def _store_and_publish(self, summary, summary_id, thread_id,
                           selected_chunks, context_selection,
                           correlation_id, latency) -> None:
        doc = {
            "summary_id": summary_id,
            "thread_id": thread_id,
            "summary_text": summary.summary_text,
            "model": summary.model,
            "chunk_ids": selected_chunks,
            "citations": [{
                "chunk_id": c.chunk_id,
                "message_doc_id": c.message_doc_id,
                "snippet": c.snippet,
                "score": c.score,
            } for c in summary.citations],
            "context_selection": context_selection or {},
            "prompt_tokens": summary.prompt_tokens,
            "completion_tokens": summary.completion_tokens,
            "generation_seconds": latency,
            "created_at": datetime.now(timezone.utc).isoformat(),
        }
        if self.consensus_detector is not None:
            messages = self.store.query_documents(
                "messages", {"thread_id": thread_id})
            signal = self.consensus_detector.detect(messages)
            doc["consensus"] = {
                "level": signal.level.value,
                "score": signal.score,
                "agree_count": signal.agree_count,
                "disagree_count": signal.disagree_count,
            }
        prev_id = (self.store.get_document("threads", thread_id)
                   or {}).get("summary_id", "")
        self.store.upsert_document("summaries", doc)
        self.store.update_document("threads", thread_id,
                                   {"summary_id": summary_id})
        if prev_id and prev_id != summary_id:
            # Supersede: when a thread re-summarizes over a larger
            # context (late-arriving messages, the stuck-document
            # sweep), exactly ONE live summary/report per thread
            # survives — the predecessor and its report are deleted,
            # not orphaned as duplicates.
            self.store.delete_document("summaries", prev_id)
            self.store.delete_documents("reports",
                                        {"summary_id": prev_id})
            self.metrics.increment("summarization_superseded_total")
        self.metrics.observe("summarization_latency_seconds", latency)
        self.metrics.increment("summarization_summaries_total")
        # Prefix-cache visibility: when the summarizer serves from the
        # in-process engine, surface its cross-request KV reuse so the
        # ops dashboards can see the shared-template hit rate (and an
        # eviction-thrashing pool shows up as a falling rate, not as an
        # unexplained TTFT regression).
        eng = getattr(self.summarizer, "engine", None)
        if eng is not None and hasattr(eng, "prefix_stats"):
            ps = eng.prefix_stats()
            if ps.get("enabled"):
                self.metrics.gauge("summarization_prefix_hit_rate",
                                   ps["hit_rate"])
                self.metrics.gauge(
                    "summarization_prefill_tokens_saved",
                    ps["prefill_tokens_saved"])
        self.publisher.publish(ev.SummaryComplete(
            summary_id=summary_id, thread_id=thread_id,
            correlation_id=correlation_id))

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.SummarizationFailed(
            thread_id=data.get("thread_id", ""),
            summary_id=data.get("summary_id", ""),
            error=str(error), error_type=type(error).__name__,
            attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
