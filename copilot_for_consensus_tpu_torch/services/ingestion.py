"""Ingestion service: sources CRUD, archive fetch, dedupe, scheduling.

Reference behaviors kept (``ingestion/app/service.py``):
* sha256 content dedupe before storing (``:1149``) — re-ingesting the
  same archive is a no-op,
* raw blob into the archive store + ``archives`` record + publish
  ``ArchiveIngested`` (``:1194,1328``),
* source CRUD with cascade delete via ``SourceDeletionRequested``
  (``:341``),
* periodic scheduler triggering enabled sources
  (``app/scheduler.py:13,72``).
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from datetime import datetime, timezone
from dataclasses import asdict
from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.archive.base import ArchiveStore
from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.core.ids import ID_HEX_LEN
from copilot_for_consensus_tpu_torch.fetch.base import (
    ArchiveFetcher,
    FetchError,
    SourceConfig,
)
from copilot_for_consensus_tpu_torch.services.base import BaseService


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


class IngestionService(BaseService):
    name = "ingestion"
    consumes = ("SourceDeletionRequested",)

    def __init__(self, publisher, store, archive_store: ArchiveStore,
                 fetchers: Mapping[str, ArchiveFetcher],
                 bus_watermark: int = 0, bus_poll_s: float = 0.5,
                 bus_pause_max_s: float = 300.0, **kw):
        super().__init__(publisher, store, **kw)
        self.archive_store = archive_store
        self.fetchers = dict(fetchers)
        # Ingest-side backpressure (the SCALE_BROKER lesson: triggering
        # every archive at once floods json.parsed 4x past the warn
        # SLO): with a watermark configured, trigger_source pauses
        # between archives until every pipeline queue drains below it.
        # scripts/scale_bench.py used to do this externally; it is now
        # first-class, fed by the broker's depth introspection
        # (publisher.pending_depths()).
        self.bus_watermark = int(bus_watermark or 0)
        self.bus_poll_s = bus_poll_s
        self.bus_pause_max_s = bus_pause_max_s

    # ---- sources CRUD (REST surface of the reference, ``app/api.py``) --

    def create_source(self, source: SourceConfig | dict[str, Any]) -> dict:
        doc = asdict(source) if isinstance(source, SourceConfig) else dict(source)
        doc.pop("options", None)
        doc.setdefault("source_id", doc.get("name") or uuid.uuid4().hex[:16])
        doc.setdefault("name", doc["source_id"])
        doc.setdefault("fetcher", "local")
        doc.setdefault("created_at", _now_iso())
        doc.setdefault("enabled", True)
        self.store.upsert_document("sources", doc)
        return doc

    def get_source(self, source_id: str) -> dict | None:
        return self.store.get_document("sources", source_id)

    def list_sources(self) -> list[dict]:
        return self.store.query_documents("sources", {})

    def update_source(self, source_id: str, fields: dict) -> bool:
        return self.store.update_document("sources", source_id, fields)

    def delete_source(self, source_id: str,
                      requested_by: str = "") -> None:
        """Cascade delete: every stage cleans its own documents on
        ``SourceDeletionRequested`` (reference ``service.py:341``)."""
        self.publisher.publish(ev.SourceDeletionRequested(
            source_id=source_id, requested_by=requested_by,
            correlation_id=uuid.uuid4().hex))

    # ---- ingest path ---------------------------------------------------

    def trigger_source(self, source_id: str) -> list[str]:
        """Fetch + ingest every archive of a source; returns archive ids
        actually ingested (deduped ones excluded)."""
        doc = self.get_source(source_id)
        if doc is None:
            raise KeyError(f"unknown source {source_id}")
        source = SourceConfig(
            name=doc.get("name", source_id),
            fetcher=doc.get("fetcher", "local"),
            location=doc.get("location", ""),
            enabled=doc.get("enabled", True),
            schedule_seconds=int(doc.get("schedule_seconds", 0)),
            options=dict(doc.get("metadata", {})),
        )
        fetcher = self.fetchers.get(source.fetcher)
        if fetcher is None:
            raise FetchError(f"no fetcher driver {source.fetcher!r}")
        correlation_id = uuid.uuid4().hex
        ingested = []
        for fetched in fetcher.fetch(source):
            self._await_bus_capacity()
            aid = self.ingest_archive(
                source_id=doc["source_id"], content=fetched.content,
                archive_uri=fetched.uri, filename=fetched.filename,
                correlation_id=correlation_id)
            if aid:
                ingested.append(aid)
        self.store.update_document("sources", doc["source_id"], {
            "last_fetch_at": _now_iso(), "last_fetch_status": "ok"})
        return ingested

    def _await_bus_capacity(self) -> float:
        """Hold the next archive until every non-failure queue is below
        the watermark (stop-aware via the base throttle release event,
        bounded by ``bus_pause_max_s``). Returns seconds waited."""
        if not self.bus_watermark:
            return 0.0
        depths_fn = getattr(self.publisher, "pending_depths", None)
        if not callable(depths_fn):
            return 0.0
        t0 = time.monotonic()
        while time.monotonic() - t0 < self.bus_pause_max_s:
            try:
                depths = depths_fn()
            # best-effort backpressure probe: if the depth poll dies,
            # stop pausing and ingest — no envelope is acked here
            except Exception:  # jaxlint: disable=dura-ack-swallow
                break
            worst = max(
                (d for rk, d in depths.items()
                 if not rk.endswith((".failed", ".dlq"))), default=0)
            if worst < self.bus_watermark:
                break
            self.metrics.increment("bus_throttle_total",
                                   labels={"service": self.name})
            if self._throttle_release.wait(self.bus_poll_s):
                break
        return time.monotonic() - t0

    def ingest_archive(self, source_id: str, content: bytes,
                       archive_uri: str = "", filename: str = "",
                       correlation_id: str = "") -> str | None:
        """Content-addressed ingest (reference ``service.py:727,1149``).
        Returns the archive id, or None when deduped. Each archive's
        ingest runs under an ``ingestion`` stage span (obs/trace.py) —
        the ROOT of the archive's pipeline trace, so the whole
        archive→parse→chunk→embed→summarize→report DAG hangs off one
        named stage instead of a bare publish."""
        from copilot_for_consensus_tpu_torch.obs import trace

        with trace.span(self.name, kind="stage", service=self.name,
                        correlation_id=correlation_id,
                        event_type="ArchiveIngested"):
            return self._ingest_archive(source_id, content, archive_uri,
                                        filename, correlation_id)

    def _ingest_archive(self, source_id: str, content: bytes,
                        archive_uri: str, filename: str,
                        correlation_id: str) -> str | None:
        sha256 = hashlib.sha256(content).hexdigest()
        archive_id = sha256[:ID_HEX_LEN]  # == generate_archive_id_from_bytes
        existing = self.store.get_document("archives", archive_id)
        if existing is not None:
            self.metrics.increment("ingestion_dedup_total")
            self.logger.info("archive deduped", archive_id=archive_id)
            return None
        uri = self.archive_store.save(archive_id, content,
                                      {"source_id": source_id})
        self.store.insert_or_ignore("archives", {
            "archive_id": archive_id,
            "source_id": source_id,
            "uri": archive_uri or uri,
            "filename": filename,
            "sha256": sha256,
            "size_bytes": len(content),
            "ingested_at": _now_iso(),
            "parsed": False,
        })
        self.publisher.publish(ev.ArchiveIngested(
            archive_id=archive_id, source_id=source_id,
            archive_uri=archive_uri or uri, sha256=sha256,
            size_bytes=len(content), correlation_id=correlation_id))
        self.metrics.increment("ingestion_archives_total")
        return archive_id

    # ---- cascade cleanup ----------------------------------------------

    def on_SourceDeletionRequested(self, event: ev.SourceDeletionRequested):
        archives = self.store.query_documents(
            "archives", {"source_id": event.source_id})
        for a in archives:
            self.archive_store.delete(a["archive_id"])
        n = self.store.delete_documents("archives",
                                        {"source_id": event.source_id})
        self.store.delete_document("sources", event.source_id)
        self.publisher.publish(ev.SourceCleanupProgress(
            source_id=event.source_id, stage="ingestion",
            deleted_count=n, correlation_id=event.correlation_id))

    # ---- startup requeue ----------------------------------------------

    def startup(self) -> None:
        from copilot_for_consensus_tpu_torch.core.startup import StartupRequeue
        StartupRequeue(self.store, self.publisher,
                       self.logger).requeue_incomplete(
            "archives", {"parsed": False},
            lambda d: ev.ArchiveIngested(
                archive_id=d["archive_id"], source_id=d.get("source_id", ""),
                archive_uri=d.get("uri", ""),
                sha256=d.get("sha256", ""),
                size_bytes=d.get("size_bytes", 0)))

    def failure_event(self, envelope, error, attempts):
        data = envelope.get("data", {})
        return ev.ArchiveIngestionFailed(
            source_id=data.get("source_id", ""),
            archive_uri=data.get("archive_uri", ""),
            error=str(error), error_type=type(error).__name__,
            attempts=attempts,
            correlation_id=data.get("correlation_id", ""))


class IngestionScheduler:
    """Periodic trigger loop (reference ``app/scheduler.py:13,72``)."""

    def __init__(self, service: IngestionService,
                 tick_seconds: float = 30.0):
        self.service = service
        self.tick_seconds = tick_seconds
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def due_sources(self, now: float | None = None) -> list[dict]:
        now = time.time() if now is None else now
        due = []
        for doc in self.service.list_sources():
            seconds = int(doc.get("schedule_seconds", 0))
            if not doc.get("enabled", True) or seconds <= 0:
                continue
            last = doc.get("last_fetch_at")
            last_ts = (datetime.fromisoformat(last).timestamp()
                       if last else 0.0)
            if now - last_ts >= seconds:
                due.append(doc)
        return due

    def tick(self) -> int:
        n = 0
        for doc in self.due_sources():
            try:
                self.service.trigger_source(doc["source_id"])
                n += 1
            except Exception as exc:
                self.service.logger.error("scheduled ingest failed",
                                          source=doc["source_id"],
                                          error=str(exc))
        return n

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.tick_seconds):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ingestion-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
