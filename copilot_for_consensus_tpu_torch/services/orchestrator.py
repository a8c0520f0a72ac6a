"""Orchestration service: decides which threads to (re)summarize and
selects their context under a token budget.

Reference behaviors kept (``orchestrator/app/service.py:45,328,411``):
* thread resolution from embedding events (``:383``),
* dedupe via the deterministic summary id over (thread, selected chunks)
  (``:481-517``) — unchanged context → no duplicate summarization,
* candidate pool = 2 × top_k (``:42``), token budget selection
  (``context_selectors.py:94-107``),
* ``SummarizationRequested`` carries ``selected_chunks`` + selection
  metadata (``:676-690``).

Improved over the reference: candidates are scored by real query-vector
similarity (thread subject + recent text embedded through the first-party
encoder) instead of the neutral-score 0.5 doc-store fallback
(``context_sources.py:21,71-83``).
"""

from __future__ import annotations

from dataclasses import dataclass

from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.ids import generate_summary_id
from copilot_for_consensus_tpu_torch.core.retry import DocumentNotFoundError
from copilot_for_consensus_tpu_torch.embedding.base import EmbeddingProvider
from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.text.chunkers import estimate_tokens
from copilot_for_consensus_tpu_torch.vectorstore.base import VectorStore


@dataclass
class Candidate:
    chunk_id: str
    text: str
    score: float
    message_doc_id: str = ""
    token_count: int = 0


@dataclass
class SelectionResult:
    selected: list[Candidate]
    strategy: str
    candidates_considered: int
    token_budget: int
    tokens_used: int


class ContextSelector:
    """Top-k relevance under a token budget (reference
    ``TopKRelevanceSelector``, ``context_selectors.py:20,39,94-107``)."""

    name = "top_k_relevance"

    def __init__(self, top_k: int = 12, context_window_tokens: int = 3000):
        self.top_k = top_k
        self.context_window_tokens = context_window_tokens

    def select(self, candidates: list[Candidate]) -> SelectionResult:
        ranked = sorted(candidates, key=lambda c: c.score, reverse=True)
        selected: list[Candidate] = []
        used = 0
        for cand in ranked:
            if len(selected) >= self.top_k:
                break
            tokens = cand.token_count or estimate_tokens(cand.text)
            if used + tokens > self.context_window_tokens and selected:
                continue
            selected.append(cand)
            used += tokens
        return SelectionResult(
            selected=selected, strategy=self.name,
            candidates_considered=len(candidates),
            token_budget=self.context_window_tokens, tokens_used=used)


class OrchestrationService(BaseService):
    name = "orchestrator"
    consumes = ("EmbeddingsGenerated",)

    def __init__(self, publisher, store,
                 vector_store: VectorStore | None = None,
                 embedding_provider: EmbeddingProvider | None = None,
                 selector: ContextSelector | None = None,
                 candidate_multiplier: int = 2, **kw):
        super().__init__(publisher, store, **kw)
        self.vector_store = vector_store
        self.embedding_provider = embedding_provider
        self.selector = selector or ContextSelector()
        self.candidate_multiplier = candidate_multiplier

    def startup(self) -> None:
        """Requeue threads whose summary never materialized — the
        summarization stage's recovery spine. The PIPELINED summarizer
        acks the bus before the summary is durable; a crash between
        engine ack and report store otherwise loses that summary
        forever (no redelivery). Re-orchestration is idempotent: the
        deterministic summary id dedupes an unchanged context, and
        partially-embedded threads re-orchestrate again when their
        remaining embeddings land (the changed-context path)."""
        from copilot_for_consensus_tpu_torch.core.startup import StartupRequeue
        from copilot_for_consensus_tpu_torch.tools.retry_job import (
            threads_recovery_rule,
        )

        rule = threads_recovery_rule()
        StartupRequeue(self.store, self.publisher,
                       self.logger).requeue_incomplete(
            rule.collection, rule.stuck_filter, rule.event_factory)

    def on_EmbeddingsGenerated(self, event: ev.EmbeddingsGenerated) -> None:
        thread_ids = event.thread_ids or self._resolve_threads(
            event.chunk_ids)
        for tid in thread_ids:
            self.orchestrate_thread(tid, event.correlation_id)

    def on_wave_EmbeddingsGenerated(self, events):
        """Batched dispatch (services/base.py wave contract): the
        events arrive one per embed wave but the work is per THREAD —
        within a fetch wave the same thread recurs many times (bulk
        ingest emits one event per message), and every trigger before
        the thread's last one would defer on the unembedded-chunks
        debounce anyway. Deduplicate: each unique thread orchestrates
        ONCE, from the finisher of the LAST event that names it (so
        its SummarizationRequested parents under that envelope's stage
        span, and a failure nacks the envelope whose redelivery
        re-covers the thread)."""
        resolved: list[list[str]] = []
        owner: dict[str, int] = {}
        for k, e in enumerate(events):
            tids = e.thread_ids or self._resolve_threads(e.chunk_ids)
            resolved.append(tids)
            for tid in tids:
                owner[tid] = k          # last event in the wave wins
        def finisher(k: int, event: ev.EmbeddingsGenerated):
            def run():
                for tid in resolved[k]:
                    if owner[tid] == k:
                        self.orchestrate_thread(tid,
                                                event.correlation_id)
            return run

        return [finisher(k, e) for k, e in enumerate(events)]

    def _resolve_threads(self, chunk_ids: list[str]) -> list[str]:
        docs = self.store.query_documents(
            "chunks", {"chunk_id": {"$in": chunk_ids}})
        if not docs and chunk_ids:
            raise DocumentNotFoundError("chunks not visible yet")
        return sorted({d.get("thread_id", "") for d in docs
                       if d.get("thread_id")})

    # ---- context retrieval --------------------------------------------

    def _query_vector(self, thread: dict) -> list[float] | None:
        if self.embedding_provider is None:
            return None
        text = thread.get("subject", "")
        # Ground the query in the thread's own content: subject + the
        # first chunk of discussion.
        chunks = self.store.query_documents(
            "chunks", {"thread_id": thread["thread_id"]},
            sort=[("seq", 1)], limit=2)
        if chunks:
            text = text + " " + " ".join(
                c.get("text", "")[:400] for c in chunks)
        return self.embedding_provider.embed(text)

    def _retrieve_context(self, thread: dict) -> list[Candidate]:
        pool = self.selector.top_k * self.candidate_multiplier
        tid = thread["thread_id"]
        qvec = self._query_vector(thread)
        if self.vector_store is not None and qvec is not None:
            # top-k context selection is a first-class traced stage:
            # the span carries the store's route/nprobe/lists-scanned
            # stats so tracepath can attribute retrieval latency to
            # the index configuration, not just "orchestrator time"
            from copilot_for_consensus_tpu_torch.obs import trace
            with trace.child_span("retrieval", "vector_topk",
                                  thread_id=tid, top_k=pool) as sp:
                hits = self.vector_store.query(
                    qvec, top_k=pool, flt={"thread_id": tid})
                stats = getattr(self.vector_store,
                                "last_query_stats", None)
                if stats:
                    sp.attrs.update(stats)
                sp.attrs["hits"] = len(hits)
            if hits:
                by_id = {
                    d["chunk_id"]: d for d in self.store.query_documents(
                        "chunks",
                        {"chunk_id": {"$in": [h.id for h in hits]}})
                }
                return [
                    Candidate(
                        chunk_id=h.id,
                        text=by_id.get(h.id, {}).get("text", ""),
                        score=h.score,
                        message_doc_id=by_id.get(h.id, {}).get(
                            "message_doc_id", ""),
                        token_count=by_id.get(h.id, {}).get(
                            "token_count", 0))
                    for h in hits if h.id in by_id
                ]
        # Degraded no-vector-store mode (reference ``service.py:98-101``):
        # every thread chunk with neutral score, capped at the pool size.
        docs = self.store.query_documents(
            "chunks", {"thread_id": tid}, sort=[("seq", 1)], limit=pool)
        return [Candidate(chunk_id=d["chunk_id"], text=d.get("text", ""),
                          score=0.5,
                          message_doc_id=d.get("message_doc_id", ""),
                          token_count=d.get("token_count", 0))
                for d in docs]

    # ---- orchestration -------------------------------------------------

    def orchestrate_thread(self, thread_id: str,
                           correlation_id: str = "") -> str | None:
        """Returns the summary id requested, or None when deduped."""
        thread = self.store.get_document("threads", thread_id)
        if thread is None:
            raise DocumentNotFoundError(f"thread {thread_id} not in store")
        # Debounce bulk ingest: while the thread still has unembedded
        # chunks, every embedding batch would otherwise orchestrate a
        # slightly larger context → a NEW deterministic summary id →
        # duplicate summarization work (measured on the 100k broker
        # run: 41,313 summaries for 12,520 threads, 3.3× churn). Defer
        # instead — the thread's remaining EmbeddingsGenerated events
        # re-trigger, and the last one finds the context complete. A
        # permanently-unembeddable chunk keeps the thread deferred,
        # which is correct (its context is incomplete) and surfaced by
        # the chunks retry rule's exhausted-documents gauge.
        pending = self.store.count_documents(
            "chunks", {"thread_id": thread_id,
                       "embedding_generated": False})
        if pending:
            self.metrics.increment("orchestrator_deferred_total")
            return None
        candidates = self._retrieve_context(thread)
        if not candidates:
            return None
        result = self.selector.select(candidates)
        chunk_ids = [c.chunk_id for c in result.selected]
        summary_id = generate_summary_id(thread_id, chunk_ids)
        if self.store.get_document("summaries", summary_id) is not None:
            if thread.get("summary_id") != summary_id:
                # Backfill the thread→summary link: a crash between the
                # summary upsert and this thread update (or an archive
                # redelivery replacing the thread doc) loses ONLY the
                # link — without this repair the recovery spine would
                # re-orchestrate into the dedup forever and report the
                # thread as permanently unsummarized.
                self.store.update_document(
                    "threads", thread_id, {"summary_id": summary_id})
            self.metrics.increment("orchestrator_dedup_total")
            return None
        self.publisher.publish(ev.SummarizationRequested(
            thread_id=thread_id, summary_id=summary_id,
            selected_chunks=chunk_ids,
            context_selection={
                "strategy": result.strategy,
                "candidates_considered": result.candidates_considered,
                "token_budget": result.token_budget,
                "tokens_used": result.tokens_used,
                "scores": {c.chunk_id: round(c.score, 4)
                           for c in result.selected},
            },
            correlation_id=correlation_id))
        self.metrics.increment("orchestrator_requests_total")
        return summary_id

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        thread_ids = data.get("thread_ids") or [data.get("thread_id", "")]
        return ev.OrchestrationFailed(
            thread_id=thread_ids[0] if thread_ids else "",
            error=str(error), error_type=type(error).__name__,
            attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
