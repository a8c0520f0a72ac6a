"""Parsing service: mbox archive → normalized message + thread documents.

Reference behaviors kept (``parsing/app/service.py:257``):
* stdlib-mailbox parse, header decode, body extraction
  (``app/parser.py:42,161-299`` → our ``text/mbox.py``),
* normalization: HTML strip, signature + quoted-reply removal
  (``app/normalizer.py:17,128,144`` → ``text/normalizer.py``),
* thread building by in_reply_to/references chain with subject fallback
  (``app/thread_builder.py:16,125`` → ``text/threads.py``),
* draft mention detection (``app/draft_detector.py:9`` → ``text/drafts.py``),
* ONE ``JSONParsed`` event per message (``service.py:681``).
"""

from __future__ import annotations

from datetime import datetime, timezone

from copilot_for_consensus_tpu_torch.archive.base import ArchiveStore
from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.ids import (
    generate_message_doc_id,
)
from copilot_for_consensus_tpu_torch.core.retry import DocumentNotFoundError
from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.text.drafts import detect_draft_mentions
from copilot_for_consensus_tpu_torch.text.mbox import parse_mbox_bytes
from copilot_for_consensus_tpu_torch.text.normalizer import TextNormalizer
from copilot_for_consensus_tpu_torch.text.threads import ThreadBuilder


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


class ParsingService(BaseService):
    name = "parsing"
    consumes = ("ArchiveIngested", "SourceDeletionRequested")

    def __init__(self, publisher, store, archive_store: ArchiveStore,
                 normalizer: TextNormalizer | None = None, **kw):
        super().__init__(publisher, store, **kw)
        self.archive_store = archive_store
        self.normalizer = normalizer or TextNormalizer()
        self.thread_builder = ThreadBuilder()

    def on_ArchiveIngested(self, event: ev.ArchiveIngested) -> None:
        self.process_archive(event.archive_id, event.correlation_id)

    def _build_archive(self, archive_id: str, archive_doc: dict) -> dict:
        """Parse one archive into write-ready documents (no store
        round-trips beyond the archive-bytes load): thread docs +
        normalized message docs, in the order the storing phase must
        write them (threads before message events — the
        docs-before-events crash-consistency contract below)."""
        raw = self.archive_store.load(archive_id)
        source_id = archive_doc.get("source_id", "")

        parsed = []
        html_flags = {}
        for msg, is_html in parse_mbox_bytes(raw):
            parsed.append(msg)
            html_flags[id(msg)] = is_html
        threads = self.thread_builder.build_threads(parsed)
        thread_of_index: dict[int, str] = {}
        for tid, th in threads.items():
            for i in th.message_indices:
                thread_of_index[i] = tid

        doc_ids = [
            generate_message_doc_id(archive_id, msg.message_id, idx)
            for idx, msg in enumerate(parsed)
        ]
        thread_fields: list[tuple[str, dict]] = []
        for tid, th in threads.items():
            members = [parsed[i] for i in th.message_indices]
            draft_mentions = sorted({
                d for m in members
                for d in detect_draft_mentions(m.body_raw)})
            thread_fields.append((tid, {
                "thread_id": tid,
                "archive_ids": [archive_id],
                "source_id": source_id,
                "subject": th.subject,
                "root_message_id": th.root_message_id,
                "message_ids": [m.message_id for m in members],
                "message_doc_ids": [doc_ids[i] for i in th.message_indices],
                "participants": th.participants,
                # denormalized count: participant-range filters and
                # sorts push down to the store (SQL/Cosmos operators
                # can't take len() of a JSON list — reporting.get_threads
                # materialized the whole collection per page without it)
                "participant_count": len(th.participants or []),
                "message_count": len(members),
                "first_message_date": th.first_date,
                "last_message_date": th.last_date,
                "draft_mentions": draft_mentions,
            }))

        message_docs: list[dict] = []
        for idx, msg in enumerate(parsed):
            body = self.normalizer.normalize(
                msg.body_raw, is_html=html_flags.get(id(msg), False))
            message_docs.append({
                "message_doc_id": doc_ids[idx],
                "archive_id": archive_id,
                "source_id": source_id,
                "message_id": msg.message_id,
                "thread_id": thread_of_index.get(idx, ""),
                "subject": msg.subject,
                "from_addr": msg.from_addr,
                "from_name": msg.from_name,
                "to_addrs": msg.to_addrs,
                "date": msg.date,
                "in_reply_to": msg.in_reply_to,
                "references": msg.references,
                "body": body,
                "draft_mentions": detect_draft_mentions(body),
                "chunked": False,
            })
        return {"archive_id": archive_id, "threads": thread_fields,
                "messages": message_docs, "n_messages": len(parsed)}

    def _store_parsed(self, built: list[dict]) -> dict[str, list[dict]]:
        """Write one or more built archives and return the message docs
        actually INSERTED per archive (whose JSONParsed events the
        caller publishes).

        Thread documents FIRST, message events after: every JSONParsed
        event fans out to consumers that will resolve the message's
        thread doc (the orchestrator hard-requires it). Publishing the
        per-message events before the archive's thread docs existed
        opened a race as long as the whole archive's parse (~minutes
        for a 2,500-message archive on a small host) — far beyond the
        retry budget; diagnosed from the r3 scale run's 313
        DocumentNotFoundError("thread ... not in store") exhaustions
        (red artifact preserved at docs/artifacts/SCALE_BROKER_r3
        .json). Docs-before-events is the same crash-consistency
        ordering the startup requeue assumes.

        Message writes are the batched hot path: ONE multi-get of the
        already-present ids + ONE dup-tolerant insert_many replaces
        the old insert_or_ignore-per-message round-trips (2,500 per
        reference monthly archive)."""
        for b in built:
            for tid, fields in b["threads"]:
                # Archive redeliveries re-run this loop (at-least-once),
                # so the write must not clobber fields other writers
                # own. A read-carry-replace (get → copy summary_id →
                # upsert) loses the update when a summary lands between
                # the read and the replace — a ZOMBIE parse (lease
                # expired mid-parse, the redelivery already finished
                # elsewhere) can wipe a thread's summary link minutes
                # later. update_document merges just our fields under
                # the store's lock, so the recovery spine's fields
                # (summary_id, attempt_count, last_attempt_at) survive
                # without being read at all.
                if not self.store.update_document("threads", tid, fields):
                    self.store.upsert_document("threads", {
                        **fields, "parsed_at": _now_iso()})

        all_ids = [d["message_doc_id"] for b in built
                   for d in b["messages"]]
        existing = self.store.get_documents("messages", all_ids)
        to_publish: dict[str, list[dict]] = {}
        to_insert: list[dict] = []
        for b in built:
            fresh = [d for d in b["messages"]
                     if d["message_doc_id"] not in existing]
            to_insert.extend(fresh)
            # Redelivery re-covers the insert-committed-but-events-
            # unpublished crash window (bulk insert widened it from
            # one message to the whole wave): messages already stored
            # but not yet chunked republish their JSONParsed too.
            # Chunking-in-progress races produce bounded duplicate
            # events — idempotent downstream — never lost ones; fully
            # chunked messages stay quiet.
            stored_unchunked = [
                d for d in b["messages"]
                if (cur := existing.get(d["message_doc_id"]))
                is not None and not cur.get("chunked")]
            to_publish[b["archive_id"]] = fresh + stored_unchunked
        # Dup-tolerant: a concurrent replica racing the same archive
        # inserts first and ours is ignored — worst case both publish
        # JSONParsed for a message (at-least-once; chunking is
        # idempotent), never a lost event.
        self.store.insert_many("messages", to_insert,
                               ignore_duplicates=True)

        for b in built:
            self.store.update_document("archives", b["archive_id"], {
                "parsed": True,
                "parsed_at": _now_iso(),
                "message_count": b["n_messages"],
            })
            self.metrics.increment("parsing_messages_total",
                                   b["n_messages"])
            self.logger.info("archive parsed",
                             archive_id=b["archive_id"],
                             messages=b["n_messages"],
                             threads=len(b["threads"]))
        return to_publish

    def process_archive(self, archive_id: str,
                        correlation_id: str = "") -> int:
        archive_doc = self.store.get_document("archives", archive_id)
        if archive_doc is None:
            # Event arrived before the DB write became visible — the race
            # copilot_event_retry exists for (reference event_handler.py:22).
            raise DocumentNotFoundError(f"archive {archive_id} not in store")
        built = self._build_archive(archive_id, archive_doc)
        to_publish = self._store_parsed([built])
        published = 0
        for doc in to_publish[archive_id]:
            self.publisher.publish(ev.JSONParsed(
                message_doc_id=doc["message_doc_id"],
                archive_id=archive_id,
                thread_id=doc["thread_id"],
                correlation_id=correlation_id))
            published += 1
        return published

    def on_wave_ArchiveIngested(self, events: list[ev.ArchiveIngested]):
        """Batched dispatch (services/base.py wave contract): parse a
        fetch wave of archives, then ONE shared storing phase (threads,
        one message multi-get + one insert_many across all archives,
        per-archive status flips); each envelope's finisher publishes
        ITS archive's JSONParsed events under its own stage span. A
        missing archive doc fails the wave → per-envelope fallback
        isolates it."""
        ids: list[str] = []
        seen: set[str] = set()
        for e in events:
            if e.archive_id not in seen:
                seen.add(e.archive_id)
                ids.append(e.archive_id)
        archives = self.store.get_documents("archives", ids)
        if len(archives) < len(ids):
            missing = next(i for i in ids if i not in archives)
            raise DocumentNotFoundError(
                f"{len(ids) - len(archives)} of {len(ids)} wave "
                f"archives not in store (first: {missing})")
        built = [self._build_archive(aid, archives[aid]) for aid in ids]
        to_publish = self._store_parsed(built)

        def finisher(event: ev.ArchiveIngested):
            def publish():
                for doc in to_publish.pop(event.archive_id, []):
                    self.publisher.publish(ev.JSONParsed(
                        message_doc_id=doc["message_doc_id"],
                        archive_id=event.archive_id,
                        thread_id=doc["thread_id"],
                        correlation_id=event.correlation_id))
            return publish

        return [finisher(e) for e in events]

    def on_SourceDeletionRequested(self, event: ev.SourceDeletionRequested):
        n = self.store.delete_documents("messages",
                                        {"source_id": event.source_id})
        n += self.store.delete_documents("threads",
                                         {"source_id": event.source_id})
        self.publisher.publish(ev.SourceCleanupProgress(
            source_id=event.source_id, stage="parsing", deleted_count=n,
            correlation_id=event.correlation_id))

    def startup(self) -> None:
        from copilot_for_consensus_tpu_torch.core.startup import StartupRequeue
        StartupRequeue(self.store, self.publisher,
                       self.logger).requeue_incomplete(
            "archives", {"parsed": False},
            lambda d: ev.ArchiveIngested(
                archive_id=d["archive_id"],
                source_id=d.get("source_id", ""),
                archive_uri=d.get("archive_uri", "")))

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.ParsingFailed(
            archive_id=data.get("archive_id", ""), error=str(error),
            error_type=type(error).__name__, attempts=attempts,
            correlation_id=data.get("correlation_id", ""))
