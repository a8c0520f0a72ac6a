"""Embedding service: chunks → vectors in the vector store.

Reference behaviors kept (``embedding/app/service.py:35,213``): query
chunks with ``embedding_generated=False`` (``:250``), upsert to the
vector store with chunk metadata (``:421-438``), flip the status flag
(``:444``), publish ``EmbeddingsGenerated``, cascade cleanup (``:556``).
Improved: the reference embeds per-text inside its batch loop
(``:284,393``); here the whole batch goes through
``EmbeddingProvider.embed_batch`` — one MXU pass on the TPU driver.
"""

from __future__ import annotations

import contextlib
import time
from datetime import datetime, timezone

from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.retry import (
    DocumentNotFoundError,
    RetryableError,
)
from copilot_for_consensus_tpu_torch.embedding.base import EmbeddingProvider
from copilot_for_consensus_tpu_torch.engine.scheduler import EngineOverloaded
from copilot_for_consensus_tpu_torch.obs import trace
from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.vectorstore.base import VectorStore


class EmbeddingService(BaseService):
    name = "embedding"
    consumes = ("ChunksPrepared", "SourceDeletionRequested")

    def __init__(self, publisher, store, provider: EmbeddingProvider,
                 vector_store: VectorStore, batch_size: int = 64,
                 tenant: str = "", occupancy_fn=None,
                 min_batch_size: int | None = None,
                 max_batch_size: int | None = None, **kw):
        super().__init__(publisher, store, **kw)
        self.provider = provider
        self.vector_store = vector_store
        #: the BASE wave size; the effective size tracks engine
        #: headroom per wave (see :meth:`effective_batch_size`)
        self.batch_size = batch_size
        self.min_batch_size = (min_batch_size if min_batch_size
                               else max(1, batch_size // 2))
        self.max_batch_size = (max_batch_size if max_batch_size
                               else batch_size * 2)
        # Occupancy source for the wave sizing: injectable for tests;
        # defaults to the provider's engine flight recorder
        # (engine/telemetry.py, the PR-5 occupancy gauge's data).
        self._occupancy_fn = occupancy_fn or self._telemetry_occupancy
        # Multi-tenant scheduling (engine/scheduler.py): embed bursts
        # carry this tenant key into the TPU provider's scheduler so
        # they are sized/shed against latency-sensitive traffic.
        # Capability probed once (services/base.py:accepts_kwargs) —
        # duck-typed providers keep their 1-arg embed_batch and simply
        # lose the tag.
        from copilot_for_consensus_tpu_torch.services.base import (
            accepts_kwargs,
        )

        self.tenant = tenant
        self._embed_takes_tenant = "tenant" in accepts_kwargs(
            provider.embed_batch, ("tenant",))
        # Engine flight-recorder wiring: a TPU provider's embed-step
        # telemetry (engine/telemetry.py) exports into THIS service's
        # collector so it reaches the gateway /metrics scrape.
        from copilot_for_consensus_tpu_torch.engine.telemetry import (
            attach_service_collector,
        )

        attach_service_collector(provider, self.metrics)

    def _telemetry_occupancy(self) -> float | None:
        """Mean occupancy over the provider engine's recent recorded
        steps (the ``engine_slot_occupancy`` gauge's source), or None
        when the provider has no flight recorder (mock drivers) — the
        wave sizing then stays at the fixed base."""
        for attr in ("engine", "long_engine", "_engine"):
            eng = getattr(self.provider, attr, None)
            tele = getattr(eng, "telemetry", None)
            recorder = getattr(tele, "recorder", None)
            if recorder is None:
                continue
            recent = [r for r in recorder.records() if r.batch][-16:]
            if not recent:
                return None
            return sum(r.occupancy for r in recent) / len(recent)
        return None

    def effective_batch_size(self) -> int:
        """Occupancy-aware wave sizing: embed throughput tracks engine
        headroom instead of a fixed batch. A saturated engine
        (occupancy → 1, interactive traffic owns the slots) halves the
        wave so embed bursts stop piling queue-wait onto
        latency-sensitive work; an idle engine (occupancy → 0) doubles
        it so the MXU pass amortizes over a fuller tile. Linear in
        headroom between those clamps; base size when no telemetry."""
        occ = self._occupancy_fn()
        if occ is None:
            return self.batch_size
        headroom = 1.0 - min(max(float(occ), 0.0), 1.0)
        eff = int(round(self.batch_size * (0.5 + 1.5 * headroom)))
        eff = max(self.min_batch_size, min(self.max_batch_size, eff))
        self.metrics.gauge("embedding_wave_batch_size", eff)
        return eff

    def on_ChunksPrepared(self, event: ev.ChunksPrepared) -> None:
        self.process_chunks(event.chunk_ids, event.correlation_id)

    def _query_unembedded(self, chunk_ids: list[str]) -> list[dict]:
        """The stage's read: chunks still needing vectors. Raises the
        retryable not-found when NONE of the ids are visible yet (the
        event-before-store-visibility race); an empty return means
        idempotent replay (everything already embedded)."""
        docs = self.store.query_documents(
            "chunks", {"chunk_id": {"$in": chunk_ids},
                       "embedding_generated": False})
        if not docs and chunk_ids:
            known = self.store.count_documents(
                "chunks", {"chunk_id": {"$in": chunk_ids}})
            if known == 0:
                raise DocumentNotFoundError(
                    f"none of {len(chunk_ids)} chunks in store yet")
        return docs

    def _embed_docs(self, docs: list[dict],
                    correlation_id: str = "") -> int:
        """Embed chunk docs in occupancy-sized waves: ONE provider
        call, ONE vector-store add and ONE bulk flag-flip per wave."""
        t0 = time.monotonic()
        done = 0
        # sized once per dispatch from current engine headroom: waves
        # inside one dispatch share the snapshot, the next dispatch
        # re-reads it
        wave = self.effective_batch_size()
        for start in range(0, len(docs), wave):
            batch = docs[start:start + wave]
            kw = {"tenant": self.tenant} \
                if self._embed_takes_tenant and self.tenant else {}
            try:
                # engine_submit child span under the stage span: a TPU
                # provider's embed-step telemetry joins the trace via
                # the shared correlation id. The batched wave's shared
                # phase runs BEFORE any stage span exists — skip the
                # span there rather than rooting a disconnected trace
                # per embed call (the TracingDocumentStore idiom).
                span_cm = (trace.child_span(
                    "engine_submit", "embed_batch", service=self.name,
                    correlation_id=correlation_id, rows=len(batch))
                    if trace.current_ids() is not None
                    else contextlib.nullcontext())
                with span_cm:
                    vectors = self.provider.embed_batch(
                        [d.get("text", "") for d in batch], **kw)
            except EngineOverloaded as exc:
                # Scheduler shed the burst: transient backpressure, not
                # a failure — the bus retry policy backs off and the
                # already-embedded chunks in earlier batches stay
                # flagged (idempotent replay skips them).
                raise RetryableError(
                    f"embedding engine overloaded ({exc.reason}), "
                    f"retry after {exc.retry_after_s:.1f}s") from exc
            self.vector_store.add_embeddings(
                (d["chunk_id"], vec, {
                    "thread_id": d.get("thread_id", ""),
                    "message_doc_id": d.get("message_doc_id", ""),
                    "source_id": d.get("source_id", ""),
                }) for d, vec in zip(batch, vectors))
            # one bulk flag-flip per wave (the same-fields merge
            # update_documents exists for), not one round-trip per chunk
            self.store.update_documents(
                "chunks", [d["chunk_id"] for d in batch], {
                    "embedding_generated": True,
                    "embedded_at": datetime.now(timezone.utc).isoformat(),
                    "embedding_model": self.provider.model_name,
                })
            done += len(batch)
        self.metrics.observe("embedding_batch_seconds",
                             time.monotonic() - t0)
        self.metrics.increment("embedding_chunks_total", done)
        return done

    def _publish_generated(self, docs: list[dict],
                           correlation_id: str = "") -> None:
        self.publisher.publish(ev.EmbeddingsGenerated(
            chunk_ids=[d["chunk_id"] for d in docs],
            thread_ids=sorted({d.get("thread_id", "") for d in docs}
                              - {""}),
            model=self.provider.model_name,
            dimension=self.provider.dimension,
            correlation_id=correlation_id))

    def process_chunks(self, chunk_ids: list[str],
                       correlation_id: str = "") -> int:
        docs = self._query_unembedded(chunk_ids)
        if not docs:
            return 0  # all already embedded — idempotent replay
        done = self._embed_docs(docs, correlation_id)
        if done:
            self._publish_generated(docs, correlation_id)
        return done

    def on_wave_ChunksPrepared(self, events: list[ev.ChunksPrepared]):
        """Batched dispatch (services/base.py wave contract): the whole
        fetch wave's chunk ids resolve in ONE store query and embed as
        one occupancy-sized run — the provider sees full tiles instead
        of one 1-message batch per event. Each envelope's finisher
        publishes EmbeddingsGenerated for ITS chunks (schema and trace
        parentage identical to single dispatch); events whose chunks
        were all already embedded publish nothing, exactly like the
        idempotent-replay return of :meth:`process_chunks`."""
        all_ids: list[str] = []
        seen: set[str] = set()
        for e in events:
            for cid in e.chunk_ids:
                if cid not in seen:
                    seen.add(cid)
                    all_ids.append(cid)
        # One query WITHOUT the embedded filter: the wave needs to know
        # which ids are KNOWN (to mirror the single-dispatch not-found
        # classification per event) as well as which still need vectors.
        known = self.store.query_documents(
            "chunks", {"chunk_id": {"$in": all_ids}})
        known_ids = {d["chunk_id"] for d in known}
        docs = [d for d in known if not d.get("embedding_generated")]
        self._embed_docs(docs)
        by_id = {d["chunk_id"]: d for d in docs}
        claimed: set[str] = set()

        def finisher(event: ev.ChunksPrepared):
            def publish():
                if event.chunk_ids and not any(
                        c in known_ids for c in event.chunk_ids):
                    # NONE of this event's chunks are visible yet —
                    # the single-dispatch classification: a retryable
                    # not-found so the envelope nacks and redelivers,
                    # never a silent ack that strands the thread
                    # behind the orchestrator's unembedded debounce.
                    raise DocumentNotFoundError(
                        f"none of {len(event.chunk_ids)} chunks in "
                        f"store yet")
                mine = [by_id[c] for c in event.chunk_ids
                        if c in by_id and c not in claimed]
                if mine:
                    # duplicate events over the same chunks (redelivery
                    # inside one wave) publish once
                    claimed.update(d["chunk_id"] for d in mine)
                    self._publish_generated(mine,
                                            event.correlation_id)
            return publish

        return [finisher(e) for e in events]

    def on_SourceDeletionRequested(self, event: ev.SourceDeletionRequested):
        # Filtered delete on the store itself: chunk documents may already
        # be gone (the chunking stage cleans its own collection in
        # parallel), so the vector store is the source of truth here.
        try:
            n = self.vector_store.delete_by_filter(
                {"source_id": event.source_id})
        except NotImplementedError:
            docs = self.store.query_documents(
                "chunks", {"source_id": event.source_id})
            n = self.vector_store.delete([d["chunk_id"] for d in docs])
        self.publisher.publish(ev.SourceCleanupProgress(
            source_id=event.source_id, stage="embedding",
            deleted_count=n, correlation_id=event.correlation_id))
        self.publisher.publish(ev.SourceCleanupCompleted(
            source_id=event.source_id,
            stages_completed=["ingestion", "parsing", "chunking",
                              "embedding"],
            correlation_id=event.correlation_id))

    def startup(self) -> None:
        from copilot_for_consensus_tpu_torch.core.startup import StartupRequeue

        def factory(d):
            return ev.ChunksPrepared(
                message_doc_id=d.get("message_doc_id", ""),
                thread_id=d.get("thread_id", ""),
                archive_id=d.get("archive_id", ""),
                chunk_ids=[d["chunk_id"]])

        StartupRequeue(self.store, self.publisher,
                       self.logger).requeue_incomplete(
            "chunks", {"embedding_generated": False}, factory)

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.EmbeddingGenerationFailed(
            chunk_ids=data.get("chunk_ids", []), error=str(error),
            error_type=type(error).__name__, attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
