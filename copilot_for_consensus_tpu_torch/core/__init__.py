"""Core contract kernel: deterministic IDs, event models, schema validation,
runtime config loading, retry policies.

Capability parity with the reference's ``copilot_schema_validation``,
``copilot_config`` and ``copilot_event_retry`` adapter packages
(see SURVEY.md §2.1).
"""

from copilot_for_consensus_tpu_torch.core.ids import (
    generate_archive_id_from_bytes,
    generate_chunk_id,
    generate_message_doc_id,
    generate_report_id,
    generate_summary_id,
    generate_thread_id,
)
from copilot_for_consensus_tpu_torch.core.events import (
    EVENT_TYPES,
    ArchiveIngested,
    ArchiveIngestionFailed,
    ChunkingFailed,
    ChunksPrepared,
    EmbeddingGenerationFailed,
    EmbeddingsGenerated,
    Event,
    FailureEvent,
    JSONParsed,
    OrchestrationFailed,
    ParsingFailed,
    ReportDeliveryFailed,
    ReportPublished,
    SourceCleanupCompleted,
    SourceCleanupProgress,
    SourceDeletionRequested,
    SummarizationFailed,
    SummarizationRequested,
    SummaryComplete,
    make_event,
)

__all__ = [
    "EVENT_TYPES",
    "Event",
    "FailureEvent",
    "make_event",
    "ArchiveIngested",
    "ArchiveIngestionFailed",
    "ChunkingFailed",
    "ChunksPrepared",
    "EmbeddingGenerationFailed",
    "EmbeddingsGenerated",
    "JSONParsed",
    "OrchestrationFailed",
    "ParsingFailed",
    "ReportDeliveryFailed",
    "ReportPublished",
    "SourceCleanupCompleted",
    "SourceCleanupProgress",
    "SourceDeletionRequested",
    "SummarizationFailed",
    "SummarizationRequested",
    "SummaryComplete",
    "generate_archive_id_from_bytes",
    "generate_chunk_id",
    "generate_message_doc_id",
    "generate_report_id",
    "generate_summary_id",
    "generate_thread_id",
]
