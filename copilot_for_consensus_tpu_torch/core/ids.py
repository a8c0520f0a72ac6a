"""Deterministic content-addressed identifiers.

Every pipeline artifact gets a stable 16-hex id derived from its content or
its parents' ids, so re-processing the same input is idempotent end to end:
re-ingesting an archive, re-parsing a message, or re-summarizing a thread
always lands on the same document id and can be deduplicated with a single
store lookup.

Capability parity with the reference's
``copilot_schema_validation/identifier_generator.py:21-68`` (sha256 → 16 hex
chars); the derivation inputs here are this framework's own.
"""

from __future__ import annotations

import hashlib

ID_HEX_LEN = 16


def _digest(*parts: str) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part.encode("utf-8", errors="replace"))
        h.update(b"\x00")
    return h.hexdigest()[:ID_HEX_LEN]


def generate_archive_id_from_bytes(raw: bytes) -> str:
    """Archive id = content hash of the raw archive bytes (dedupe on ingest)."""
    return hashlib.sha256(raw).hexdigest()[:ID_HEX_LEN]


def generate_message_doc_id(archive_id: str, message_id: str, index: int) -> str:
    """Message document id.

    Includes the position in the archive so that malformed archives with
    duplicate/missing RFC-822 Message-IDs still yield unique, stable ids.
    """
    return _digest("msg", archive_id, message_id or "", str(index))


def generate_thread_id(normalized_subject: str, root_message_id: str) -> str:
    """Thread id from the root of the in-reply-to chain."""
    return _digest("thread", normalized_subject, root_message_id or "")


def generate_chunk_id(message_doc_id: str, seq: int) -> str:
    """Chunk id = parent message + chunk sequence number."""
    return _digest("chunk", message_doc_id, str(seq))


def generate_summary_id(thread_id: str, chunk_ids: list[str]) -> str:
    """Summary id over the exact retrieval context.

    sha256(thread_id : sorted chunk ids) — identical context selection for a
    thread produces the same summary id, which is how the orchestrator
    deduplicates repeat summarization requests (reference behavior:
    ``orchestrator/app/service.py:481-517``).
    """
    return _digest("summary", thread_id, *sorted(chunk_ids))


def generate_report_id(summary_id: str) -> str:
    """Report id under which a summary is published to the read API."""
    return _digest("report", summary_id)
