"""Chunking service: messages → token-bounded retrieval chunks.

Reference behaviors kept (``chunking/app/service.py:39,270,457``):
dup-key-tolerant chunk insert (``:343``), chunk doc shape (``:498-516``),
deterministic chunk ids, ``chunking_complete`` status flag, cascade
cleanup on source deletion (``:609``).
"""

from __future__ import annotations

from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.ids import generate_chunk_id
from copilot_for_consensus_tpu_torch.core.retry import DocumentNotFoundError
from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.text.chunkers import Chunker, TokenWindowChunker


class ChunkingService(BaseService):
    name = "chunking"
    consumes = ("JSONParsed", "SourceDeletionRequested")

    def __init__(self, publisher, store, chunker: Chunker | None = None,
                 **kw):
        super().__init__(publisher, store, **kw)
        self.chunker = chunker or TokenWindowChunker()

    def on_JSONParsed(self, event: ev.JSONParsed) -> None:
        self.process_message(event.message_doc_id, event.correlation_id)

    def _chunk_docs(self, message_doc_id: str, msg: dict
                    ) -> tuple[list[str], list[dict]]:
        """Chunk one message body into insert-ready chunk documents
        (deterministic ids — replay-idempotent by construction)."""
        chunk_ids: list[str] = []
        docs: list[dict] = []
        for chunk in self.chunker.chunk(msg.get("body", "")):
            cid = generate_chunk_id(message_doc_id, chunk.seq)
            chunk_ids.append(cid)
            docs.append({
                "chunk_id": cid,
                "message_doc_id": message_doc_id,
                "thread_id": msg.get("thread_id", ""),
                "archive_id": msg.get("archive_id", ""),
                "source_id": msg.get("source_id", ""),
                "seq": chunk.seq,
                "text": chunk.text,
                "token_count": chunk.token_count,
                "chunker": self.chunker.name,
                "embedding_generated": False,
            })
        return chunk_ids, docs

    def process_message(self, message_doc_id: str,
                        correlation_id: str = "") -> list[str]:
        msg = self.store.get_document("messages", message_doc_id)
        if msg is None:
            raise DocumentNotFoundError(
                f"message {message_doc_id} not in store")
        chunk_ids, docs = self._chunk_docs(message_doc_id, msg)
        # Idempotent: replaying JSONParsed must not duplicate chunks
        # (reference dup-key-tolerant insert, service.py:343).
        self.store.insert_many("chunks", docs, ignore_duplicates=True)
        self.store.update_document("messages", message_doc_id,
                                   {"chunked": True})
        if chunk_ids:
            self.publisher.publish(ev.ChunksPrepared(
                message_doc_id=message_doc_id,
                thread_id=msg.get("thread_id", ""),
                archive_id=msg.get("archive_id", ""),
                chunk_ids=chunk_ids, correlation_id=correlation_id))
        self.metrics.increment("chunking_chunks_total", len(chunk_ids))
        return chunk_ids

    def on_wave_JSONParsed(self, events: list[ev.JSONParsed]):
        """Batched hot path (services/base.py wave contract): the
        per-message dispatch paid 4 store round-trips per message
        (get + N chunk inserts + flag update); a wave pays ONE
        multi-get, ONE bulk insert and ONE bulk flag-flip for the
        whole fetch batch, then publishes each message's
        ChunksPrepared from its own per-envelope finisher (trace
        correctness: the follow-up parents under that envelope's
        stage span). Any message missing from the store fails the
        wave → the base class re-dispatches per envelope, so only the
        missing one nacks."""
        ids: list[str] = []
        seen: set[str] = set()
        for e in events:
            if e.message_doc_id not in seen:
                seen.add(e.message_doc_id)
                ids.append(e.message_doc_id)
        msgs = self.store.get_documents("messages", ids)
        if len(msgs) < len(ids):
            missing = next(i for i in ids if i not in msgs)
            raise DocumentNotFoundError(
                f"{len(ids) - len(msgs)} of {len(ids)} wave messages "
                f"not in store (first: {missing})")
        all_docs: list[dict] = []
        chunk_ids_of: dict[str, list[str]] = {}
        for mid in ids:
            chunk_ids, docs = self._chunk_docs(mid, msgs[mid])
            chunk_ids_of[mid] = chunk_ids
            all_docs.extend(docs)
        self.store.insert_many("chunks", all_docs,
                               ignore_duplicates=True)
        self.store.update_documents("messages", ids, {"chunked": True})
        self.metrics.increment("chunking_chunks_total", len(all_docs))

        def finisher(event: ev.JSONParsed):
            def publish():
                cids = chunk_ids_of[event.message_doc_id]
                if cids:
                    msg = msgs[event.message_doc_id]
                    self.publisher.publish(ev.ChunksPrepared(
                        message_doc_id=event.message_doc_id,
                        thread_id=msg.get("thread_id", ""),
                        archive_id=msg.get("archive_id", ""),
                        chunk_ids=cids,
                        correlation_id=event.correlation_id))
            return publish

        return [finisher(e) for e in events]

    def on_SourceDeletionRequested(self, event: ev.SourceDeletionRequested):
        n = self.store.delete_documents("chunks",
                                        {"source_id": event.source_id})
        self.publisher.publish(ev.SourceCleanupProgress(
            source_id=event.source_id, stage="chunking", deleted_count=n,
            correlation_id=event.correlation_id))

    def startup(self) -> None:
        from copilot_for_consensus_tpu_torch.core.startup import StartupRequeue
        StartupRequeue(self.store, self.publisher,
                       self.logger).requeue_incomplete(
            "messages", {"chunked": False},
            lambda d: ev.JSONParsed(
                message_doc_id=d["message_doc_id"],
                archive_id=d.get("archive_id", ""),
                thread_id=d.get("thread_id", "")))

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.ChunkingFailed(
            message_doc_id=data.get("message_doc_id", ""),
            error=str(error), error_type=type(error).__name__,
            attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
