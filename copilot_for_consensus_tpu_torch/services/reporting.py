"""Reporting service: persist published reports, serve the read API.

Reference behaviors kept (``reporting/app/service.py:46,192``): report
stored under a 16-hex id derived from the summary, thread linked, webhook
notify (``:419``), query/paginate/sort (``:532``), topic search
(``:797``), threads/messages/chunks browse (``:970-1243``). Improved:
``search_reports`` optionally does *semantic* search through the vector
store — the reference's search is substring-only ("NOT semantic",
SURVEY.md §3.3).
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
import urllib.request
from typing import Any, Callable

from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.ids import generate_report_id
from copilot_for_consensus_tpu_torch.core.retry import DocumentNotFoundError
from copilot_for_consensus_tpu_torch.services.base import BaseService


class ReportingService(BaseService):
    name = "reporting"
    consumes = ("SummaryComplete",)

    def __init__(self, publisher, store, webhook_url: str = "",
                 webhook_sender: Callable[[str, dict], None] | None = None,
                 embedding_provider=None, vector_store=None, **kw):
        super().__init__(publisher, store, **kw)
        self.webhook_url = webhook_url
        self.webhook_sender = webhook_sender or self._post_json
        self.embedding_provider = embedding_provider
        self.vector_store = vector_store
        self._participants_backfilled = False

    # ---- write path ----------------------------------------------------

    def on_SummaryComplete(self, event: ev.SummaryComplete) -> None:
        self.process_summary(event.summary_id, event.correlation_id)

    def process_summary(self, summary_id: str,
                        correlation_id: str = "") -> str:
        summary = self.store.get_document("summaries", summary_id)
        if summary is None:
            raise DocumentNotFoundError(
                f"summary {summary_id} not in store")
        thread_id = summary.get("thread_id", "")
        thread = (self.store.get_document("threads", thread_id)
                  if thread_id else None)
        if (thread is not None and thread.get("summary_id")
                and thread.get("summary_id") != summary_id):
            # Superseded while this SummaryComplete was in flight: the
            # thread re-summarized over more context and the live
            # report belongs to its CURRENT summary — publishing this
            # one would mint a duplicate terminal artifact.
            self.metrics.increment("reporting_superseded_total")
            return ""
        report_id = generate_report_id(summary_id)
        self.store.upsert_document("reports", {
            "report_id": report_id,
            "summary_id": summary_id,
            "thread_id": summary.get("thread_id", ""),
            "subject": self._thread_subject(summary.get("thread_id", "")),
            "summary_text": summary.get("summary_text", ""),
            "citations": summary.get("citations", []),
            "consensus": summary.get("consensus"),
            "model": summary.get("model", ""),
            "published_at": datetime.now(timezone.utc).isoformat(),
        })
        self.store.update_document("summaries", summary_id,
                                   {"report_id": report_id})
        if thread_id:
            # Convergent cleanup (the other half of the supersede
            # contract in summarization._store_and_publish): whichever
            # writer lands last deletes any report row a raced,
            # now-superseded summary left for this thread.
            self.store.delete_documents(
                "reports", {"thread_id": thread_id,
                            "summary_id": {"$ne": summary_id}})
        if self.webhook_url:
            try:
                self.webhook_sender(self.webhook_url, {
                    "report_id": report_id, "summary_id": summary_id})
            except Exception as exc:
                self.logger.error("webhook delivery failed",
                                  error=str(exc))
                self.publisher.publish(ev.ReportDeliveryFailed(
                    report_id=report_id, summary_id=summary_id,
                    error=str(exc), error_type=type(exc).__name__,
                    attempts=1, correlation_id=correlation_id))
        self.publisher.publish(ev.ReportPublished(
            report_id=report_id, summary_id=summary_id,
            thread_id=summary.get("thread_id", ""),
            correlation_id=correlation_id))
        self.metrics.increment("reporting_reports_total")
        return report_id

    def _thread_subject(self, thread_id: str) -> str:
        thread = self.store.get_document("threads", thread_id)
        return (thread or {}).get("subject", "")

    @staticmethod
    def _post_json(url: str, payload: dict) -> None:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10).read()

    # ---- read API ------------------------------------------------------

    def get_reports(self, *, thread_id: str | None = None,
                    sort_by: str = "published_at", descending: bool = True,
                    offset: int = 0, limit: int = 50) -> list[dict]:
        flt: dict[str, Any] = {}
        if thread_id:
            flt["thread_id"] = thread_id
        # limit/skip push down to the store (SQL LIMIT/OFFSET on the
        # indexed driver) — materializing the whole collection breaks the
        # reporting-API SLO at the 100k-message corpus.
        return self.store.query_documents(
            "reports", flt, sort=[(sort_by, -1 if descending else 1)],
            limit=limit, skip=offset)

    def get_report(self, report_id: str) -> dict | None:
        return self.store.get_document("reports", report_id)

    def search_reports(self, topic: str, *, limit: int = 20,
                       semantic: bool | None = None) -> list[dict]:
        """Substring search (reference parity); semantic search over the
        chunk index when an embedding provider + vector store are wired."""
        if semantic is None:
            semantic = (self.embedding_provider is not None
                        and self.vector_store is not None)
        if semantic and self.embedding_provider and self.vector_store:
            qvec = self.embedding_provider.embed(topic)
            hits = self.vector_store.query(qvec, top_k=limit * 3)
            thread_ids: list[str] = []
            for h in hits:
                tid = h.metadata.get("thread_id", "")
                if tid and tid not in thread_ids:
                    thread_ids.append(tid)
            out = []
            for tid in thread_ids:
                for r in self.get_reports(thread_id=tid, limit=1):
                    out.append(r)
                if len(out) >= limit:
                    break
            if out:
                return out
        needle = topic.lower()
        return [r for r in self.get_reports(limit=1 << 30)
                if needle in r.get("summary_text", "").lower()
                or needle in r.get("subject", "").lower()][:limit]

    # browse endpoints (reference ``reporting/main.py:73-474``)

    #: sortable thread fields (reference DiscussionsList.tsx query model)
    THREAD_SORTS = ("message_count", "participant_count", "subject",
                    "parsed_at")

    def get_threads(self, *, offset: int = 0, limit: int = 50,
                    source: str | None = None,
                    min_messages: int | None = None,
                    max_messages: int | None = None,
                    min_participants: int | None = None,
                    max_participants: int | None = None,
                    sort_by: str = "message_count",
                    descending: bool = True) -> list[dict]:
        """Filtered/sorted thread browse (reference
        ``ui/src/routes/DiscussionsList.tsx:11-22`` query surface:
        source, participant/message ranges, sort). Filters are pushed
        into the store query so pagination composes correctly."""
        flt: dict = {}
        if source:
            flt["source_id"] = source
        rng: dict = {}
        if min_messages is not None:
            rng["$gte"] = min_messages
        if max_messages is not None:
            rng["$lte"] = max_messages
        if rng:
            flt["message_count"] = rng
        if sort_by not in self.THREAD_SORTS:
            sort_by = "message_count"
        # participant ranges/sort hit the DENORMALIZED participant_count
        # integer the parsing service stamps on every thread doc — the
        # filter/sort/limit/skip all push down to the store, so a
        # participant-filtered page view no longer materializes the
        # whole collection (the 100k-corpus reporting-API SLO killer).
        rng = {}
        if min_participants is not None:
            rng["$gte"] = min_participants
        if max_participants is not None:
            rng["$lte"] = max_participants
        if rng or sort_by == "participant_count":
            self._backfill_participant_counts()
        if rng:
            flt["participant_count"] = rng
        return self.store.query_documents(
            "threads", flt,
            sort=[(sort_by, -1 if descending else 1)],
            limit=limit or None, skip=offset)

    def _backfill_participant_counts(self) -> None:
        """One-time lazy migration: thread docs written before the
        parse-time denormalization lack participant_count, and a
        pushed-down range filter (or Cosmos ORDER BY) would silently
        exclude them. Paid only on the first participant-filtered call
        per process, and only for the missing docs — a re-parse also
        heals them, this just doesn't require one."""
        if self._participants_backfilled:
            return
        # Batched sweep: memory stays bounded at a large corpus (the
        # 100k-thread store would otherwise materialize every legacy
        # doc, message_ids and all, in one list). The one-time write
        # cost per legacy doc is unavoidable; after the sweep the hot
        # path is pure pushdown. Each batch re-queries $exists:False,
        # so updated docs fall out of the result — no skip arithmetic.
        total = 0
        while True:
            stale = self.store.query_documents(
                "threads", {"participant_count": {"$exists": False}},
                limit=1000)
            if not stale:
                break
            for doc in stale:
                self.store.update_document(
                    "threads", doc["thread_id"],
                    {"participant_count":
                     len(doc.get("participants") or [])})
            total += len(stale)
        # Flag only AFTER the sweep completes: a mid-backfill store
        # error must surface to the caller and retry next request, not
        # silently disable the migration (= wrong filter results) for
        # the rest of the process lifetime.
        self._participants_backfilled = True
        if total:
            self.logger.info("backfilled participant_count",
                             threads=total)

    def get_thread(self, thread_id: str) -> dict | None:
        return self.store.get_document("threads", thread_id)

    def get_messages(self, thread_id: str | None = None, *,
                     offset: int = 0, limit: int = 50) -> list[dict]:
        flt = {"thread_id": thread_id} if thread_id else {}
        return self.store.query_documents("messages", flt,
                                          sort=[("date", 1)],
                                          limit=limit, skip=offset)

    def get_message(self, message_doc_id: str) -> dict | None:
        return self.store.get_document("messages", message_doc_id)

    def get_chunks(self, message_doc_id: str | None = None, *,
                   offset: int = 0, limit: int = 50) -> list[dict]:
        flt = {"message_doc_id": message_doc_id} if message_doc_id else {}
        return self.store.query_documents("chunks", flt,
                                          sort=[("seq", 1)],
                                          limit=limit, skip=offset)

    def get_sources(self) -> list[dict]:
        return self.store.query_documents("sources", {})

    def stats(self) -> dict[str, int]:
        return {c: self.store.count_documents(c, {})
                for c in ("sources", "archives", "messages", "threads",
                          "chunks", "summaries", "reports")}

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.ReportDeliveryFailed(
            report_id="", summary_id=data.get("summary_id", ""),
            error=str(error), error_type=type(error).__name__,
            attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
