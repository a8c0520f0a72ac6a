"""Event contract: envelope + the 17 pipeline event types.

The bus carries JSON envelopes with ``event_type, event_id, timestamp,
version, data`` (capability parity with the reference's
``docs/schemas/events/event-envelope.schema.json`` and the event dataclasses
re-exported by ``copilot_message_bus/__init__.py:16-45``).

Every event type has a typed dataclass with ``to_envelope()`` /
``from_envelope()`` round-tripping, and a routing key used by bus drivers
(one durable queue per routing key, as in the reference's
``infra/rabbitmq/definitions.json``).
"""

from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, ClassVar, Type

ENVELOPE_VERSION = "1.0"


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclass
class Event:
    """Base class for all pipeline events.

    Subclasses set ``event_type`` and ``routing_key`` class attributes; their
    dataclass fields form the ``data`` payload of the envelope.
    """

    event_type: ClassVar[str] = ""
    routing_key: ClassVar[str] = ""

    def to_envelope(self) -> dict[str, Any]:
        return {
            "event_type": type(self).event_type,
            "event_id": str(uuid.uuid4()),
            "timestamp": _now_iso(),
            "version": ENVELOPE_VERSION,
            "data": dataclasses.asdict(self),
        }

    @classmethod
    def from_envelope(cls, envelope: dict[str, Any]) -> "Event":
        etype = envelope.get("event_type")
        target = EVENT_TYPES.get(etype or "")
        if target is None:
            raise ValueError(f"unknown event_type: {etype!r}")
        data = envelope.get("data", {})
        names = {f.name for f in dataclasses.fields(target)}
        return target(**{k: v for k, v in data.items() if k in names})


EVENT_TYPES: dict[str, Type[Event]] = {}


def _register(cls: Type[Event]) -> Type[Event]:
    EVENT_TYPES[cls.event_type] = cls
    return cls


# --------------------------------------------------------------------------
# Forward-path events (ingest → report). One queue per routing key.
# --------------------------------------------------------------------------


@_register
@dataclass
class ArchiveIngested(Event):
    event_type: ClassVar[str] = "ArchiveIngested"
    routing_key: ClassVar[str] = "archive.ingested"

    archive_id: str = ""
    source_id: str = ""
    archive_uri: str = ""
    sha256: str = ""
    size_bytes: int = 0
    correlation_id: str = ""


@_register
@dataclass
class JSONParsed(Event):
    """One per parsed message (reference emits one JSONParsed per message,
    ``parsing/app/service.py:681``)."""

    event_type: ClassVar[str] = "JSONParsed"
    routing_key: ClassVar[str] = "json.parsed"

    message_doc_id: str = ""
    archive_id: str = ""
    thread_id: str = ""
    correlation_id: str = ""


@_register
@dataclass
class ChunksPrepared(Event):
    event_type: ClassVar[str] = "ChunksPrepared"
    routing_key: ClassVar[str] = "chunks.prepared"

    message_doc_id: str = ""
    thread_id: str = ""
    archive_id: str = ""
    chunk_ids: list[str] = field(default_factory=list)
    correlation_id: str = ""


@_register
@dataclass
class EmbeddingsGenerated(Event):
    event_type: ClassVar[str] = "EmbeddingsGenerated"
    routing_key: ClassVar[str] = "embeddings.generated"

    chunk_ids: list[str] = field(default_factory=list)
    thread_ids: list[str] = field(default_factory=list)
    model: str = ""
    dimension: int = 0
    correlation_id: str = ""


@_register
@dataclass
class SummarizationRequested(Event):
    """Carries the orchestrator's pre-selected context (chunk ids + selection
    metadata), the way the reference attaches ``selected_chunks`` +
    ``context_selection`` (``orchestrator/app/service.py:676-690``)."""

    event_type: ClassVar[str] = "SummarizationRequested"
    routing_key: ClassVar[str] = "summarization.requested"

    thread_id: str = ""
    summary_id: str = ""
    selected_chunks: list[str] = field(default_factory=list)
    context_selection: dict[str, Any] = field(default_factory=dict)
    correlation_id: str = ""


@_register
@dataclass
class SummaryComplete(Event):
    event_type: ClassVar[str] = "SummaryComplete"
    routing_key: ClassVar[str] = "summary.complete"

    summary_id: str = ""
    thread_id: str = ""
    correlation_id: str = ""


@_register
@dataclass
class ReportPublished(Event):
    event_type: ClassVar[str] = "ReportPublished"
    routing_key: ClassVar[str] = "report.published"

    report_id: str = ""
    summary_id: str = ""
    thread_id: str = ""
    correlation_id: str = ""


# --------------------------------------------------------------------------
# Source lifecycle events
# --------------------------------------------------------------------------


@_register
@dataclass
class SourceDeletionRequested(Event):
    event_type: ClassVar[str] = "SourceDeletionRequested"
    routing_key: ClassVar[str] = "source.deletion.requested"

    source_id: str = ""
    requested_by: str = ""
    correlation_id: str = ""


@_register
@dataclass
class SourceCleanupProgress(Event):
    event_type: ClassVar[str] = "SourceCleanupProgress"
    routing_key: ClassVar[str] = "source.cleanup.progress"

    source_id: str = ""
    stage: str = ""
    deleted_count: int = 0
    correlation_id: str = ""


@_register
@dataclass
class SourceCleanupCompleted(Event):
    event_type: ClassVar[str] = "SourceCleanupCompleted"
    routing_key: ClassVar[str] = "source.cleanup.completed"

    source_id: str = ""
    stages_completed: list[str] = field(default_factory=list)
    correlation_id: str = ""


# --------------------------------------------------------------------------
# Failure events — one `.failed` queue per stage (reference keeps 7).
# --------------------------------------------------------------------------


@dataclass
class FailureEvent(Event):
    """Common shape for terminal stage failures routed to `.failed` queues."""

    error: str = ""
    error_type: str = ""
    attempts: int = 0
    correlation_id: str = ""


@_register
@dataclass
class ArchiveIngestionFailed(FailureEvent):
    event_type: ClassVar[str] = "ArchiveIngestionFailed"
    routing_key: ClassVar[str] = "archive.ingestion.failed"

    source_id: str = ""
    archive_uri: str = ""


@_register
@dataclass
class ParsingFailed(FailureEvent):
    event_type: ClassVar[str] = "ParsingFailed"
    routing_key: ClassVar[str] = "parsing.failed"

    archive_id: str = ""


@_register
@dataclass
class ChunkingFailed(FailureEvent):
    event_type: ClassVar[str] = "ChunkingFailed"
    routing_key: ClassVar[str] = "chunking.failed"

    message_doc_id: str = ""


@_register
@dataclass
class EmbeddingGenerationFailed(FailureEvent):
    event_type: ClassVar[str] = "EmbeddingGenerationFailed"
    routing_key: ClassVar[str] = "embedding.generation.failed"

    chunk_ids: list[str] = field(default_factory=list)


@_register
@dataclass
class OrchestrationFailed(FailureEvent):
    event_type: ClassVar[str] = "OrchestrationFailed"
    routing_key: ClassVar[str] = "orchestration.failed"

    thread_id: str = ""


@_register
@dataclass
class SummarizationFailed(FailureEvent):
    event_type: ClassVar[str] = "SummarizationFailed"
    routing_key: ClassVar[str] = "summarization.failed"

    thread_id: str = ""
    summary_id: str = ""


@_register
@dataclass
class ReportDeliveryFailed(FailureEvent):
    event_type: ClassVar[str] = "ReportDeliveryFailed"
    routing_key: ClassVar[str] = "report.delivery.failed"

    report_id: str = ""
    summary_id: str = ""


FAILURE_EVENT_TYPES = tuple(
    name for name, cls in EVENT_TYPES.items() if issubclass(cls, FailureEvent)
)


def make_event(event_type: str, **data: Any) -> Event:
    """Construct a typed event by name (used by config-driven requeue tools)."""
    cls = EVENT_TYPES.get(event_type)
    if cls is None:
        raise ValueError(f"unknown event_type: {event_type!r}")
    return cls(**data)
