"""Periodic stuck-document retry job.

Parity with the reference's ``scripts/retry_stuck_documents.py:143``:
scan each collection for documents stuck mid-pipeline longer than a
threshold, re-publish their trigger events with exponential backoff
(5/10/20 → 60 min schedule, ``:280``), bounded per-document attempts
(``attempt_count`` / ``last_attempt_at``), run in a loop (``:575``) or
one-shot.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Callable

from copilot_for_consensus_tpu_torch.core import events as ev


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def _age_seconds(iso: str | None, now: float) -> float:
    if not iso:
        return float("inf")
    try:
        return now - datetime.fromisoformat(iso).timestamp()
    except ValueError:
        return float("inf")


@dataclass
class RetryRule:
    collection: str
    stuck_filter: dict[str, Any]
    event_factory: Callable[[dict], ev.Event]
    max_attempts: int = 5
    # exponential schedule (minutes): attempt n waits schedule[min(n, last)]
    backoff_minutes: tuple[float, ...] = (5, 10, 20, 60)


def default_rules() -> list[RetryRule]:
    return [
        RetryRule(
            "archives", {"parsed": False},
            lambda d: ev.ArchiveIngested(
                archive_id=d["archive_id"],
                source_id=d.get("source_id", ""),
                archive_uri=d.get("uri", "")),
            max_attempts=3),
        RetryRule(
            "messages", {"chunked": False},
            lambda d: ev.JSONParsed(
                message_doc_id=d["message_doc_id"],
                archive_id=d.get("archive_id", ""),
                thread_id=d.get("thread_id", "")),
            max_attempts=5),
        RetryRule(
            "chunks", {"embedding_generated": False},
            lambda d: ev.ChunksPrepared(
                message_doc_id=d.get("message_doc_id", ""),
                thread_id=d.get("thread_id", ""),
                archive_id=d.get("archive_id", ""),
                chunk_ids=[d["chunk_id"]]),
            max_attempts=5),
        threads_recovery_rule(),
    ]


def threads_recovery_rule() -> RetryRule:
    """Summarization stage: a thread without a stored summary is stuck.

    This is the recovery spine the PIPELINED summarizer leans on (it
    acks the bus BEFORE the summary is durable, so a crash between
    engine ack and report store loses the summary with no redelivery).
    Re-orchestrating is idempotent: the deterministic summary id
    dedupes an unchanged context (and the dedup branch backfills the
    thread's ``summary_id`` link if only THAT write was lost), and the
    summarizer skips summaries that already exist. The ONE definition —
    the orchestrator's startup requeue uses it too, so the cron rule
    and the boot path cannot drift. Age anchors on the thread doc's
    ``parsed_at`` (set at parse time), so healthy mid-pipeline threads
    are not churned before ``min_stuck_seconds``.
    """
    return RetryRule(
        "threads", {"summary_id": {"$exists": False}},
        lambda d: ev.EmbeddingsGenerated(thread_ids=[d["thread_id"]]),
        max_attempts=5)


def pending_counts(store: Any,
                   rules: list[RetryRule] | None = None) -> dict[str, int]:
    """Per-collection count of documents matching the retry rules' stuck
    filters (-1 = the store query raised). The single definition of
    "pending by stage" shared by the stats exporter's gauges and the
    gateway's /api/ops snapshot — if a stuck filter changes, both views
    move together."""
    out: dict[str, int] = {}
    for rule in rules or default_rules():
        try:
            out[rule.collection] = store.count_documents(
                rule.collection, rule.stuck_filter)
        except Exception:
            out[rule.collection] = -1
    return out


@dataclass
class RetryStuckDocumentsJob:
    store: Any
    publisher: Any
    rules: list[RetryRule] = field(default_factory=default_rules)
    min_stuck_seconds: float = 300.0
    # Batch jobs can't be scraped, so the sweep pushes its counters on
    # completion (reference: every pipeline service safe_push()es after
    # each event; its retry job is the canonical pushgateway client).
    metrics: Any = None

    def run_once(self, now: float | None = None) -> dict[str, int]:
        """One sweep; returns per-collection requeue counts."""
        now = time.time() if now is None else now
        t0 = time.monotonic()
        counts: dict[str, int] = {}
        for rule in self.rules:
            pk = self._primary_key(rule.collection)
            n = exhausted = 0
            for doc in self.store.query_documents(rule.collection,
                                                  rule.stuck_filter):
                attempts = int(doc.get("attempt_count", 0))
                if attempts >= rule.max_attempts:
                    exhausted += 1
                    continue
                ref_ts = doc.get("last_attempt_at") or doc.get(
                    "ingested_at") or doc.get("parsed_at")
                age = _age_seconds(ref_ts, now)
                backoff = rule.backoff_minutes[
                    min(attempts, len(rule.backoff_minutes) - 1)] * 60
                if age < max(self.min_stuck_seconds, backoff):
                    continue
                self.publisher.publish(rule.event_factory(doc))
                self.store.update_document(rule.collection, doc[pk], {
                    "attempt_count": attempts + 1,
                    "last_attempt_at": _now_iso(),
                })
                n += 1
            counts[rule.collection] = n
            if self.metrics is not None:
                labels = {"collection": rule.collection}
                self.metrics.increment("retry_requeued_total", n,
                                       labels=labels)
                # Documents past max_attempts need operator attention —
                # the sweep will never touch them again.
                self.metrics.gauge("retry_exhausted_documents",
                                   float(exhausted), labels=labels)
        if self.metrics is not None:
            self.metrics.observe("retry_sweep_seconds",
                                 time.monotonic() - t0)
            self.metrics.gauge("retry_last_sweep_timestamp", time.time())
            self.metrics.safe_push()
        return counts

    @staticmethod
    def _primary_key(collection: str) -> str:
        from copilot_for_consensus_tpu_torch.storage.registry import primary_key
        return primary_key(collection)

    def run_loop(self, interval_seconds: float = 300.0,
                 stop_flag=None) -> None:
        import threading
        stop = stop_flag or threading.Event()
        while not stop.wait(interval_seconds):
            self.run_once()
