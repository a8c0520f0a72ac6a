"""Summarizer ABC + domain models + mock driver.

Models mirror the reference's ``copilot_summarization/models.py:10-65``
(Citation / Thread / Summary) and the ABC mirrors
``summarizer.py:11-32`` (``summarize(Thread) -> Summary``). Citations are
derived from the retrieved chunks, not parsed out of LLM output — the
reference's deliberate choice (``summarization/app/service.py:291-307``)
kept here.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Any


class SummarizationError(Exception):
    pass


class RateLimitError(SummarizationError):
    """Backend asked us to slow down (reference
    ``openai_summarizer.py:23,46``); the service retry loop waits."""

    def __init__(self, message: str = "", retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class Citation:
    chunk_id: str
    message_doc_id: str = ""
    snippet: str = ""
    score: float = 0.0


@dataclass
class ThreadContext:
    """What the summarizer sees: the thread plus pre-selected context."""

    thread_id: str
    subject: str = ""
    participants: list[str] = field(default_factory=list)
    message_count: int = 0
    chunks: list[dict[str, Any]] = field(default_factory=list)
    # each chunk dict: {chunk_id, message_doc_id, text, score}
    context_window_tokens: int = 4096


@dataclass
class Summary:
    thread_id: str
    summary_text: str
    citations: list[Citation] = field(default_factory=list)
    model: str = ""
    generated_at: float = field(default_factory=time.time)
    prompt_tokens: int = 0
    completion_tokens: int = 0


class Summarizer(abc.ABC):
    @abc.abstractmethod
    def summarize(self, thread: ThreadContext) -> Summary: ...

    def close(self) -> None:
        pass


def citations_from_chunks(chunks: list[dict[str, Any]],
                          max_snippet: int = 160) -> list[Citation]:
    return [
        Citation(
            chunk_id=c.get("chunk_id", ""),
            message_doc_id=c.get("message_doc_id", ""),
            snippet=(c.get("text") or "")[:max_snippet],
            score=float(c.get("score", 0.0)),
        )
        for c in chunks
    ]


class MockSummarizer(Summarizer):
    """Extractive mock: first sentences of the top chunks. Deterministic,
    dependency-free — the test backbone, like the reference's
    ``MockSummarizer`` (``mock_summarizer.py:17``)."""

    def __init__(self, max_sentences: int = 3):
        self.max_sentences = max_sentences

    def summarize(self, thread: ThreadContext) -> Summary:
        sentences: list[str] = []
        for chunk in thread.chunks[: self.max_sentences]:
            text = (chunk.get("text") or "").strip().replace("\n", " ")
            if text:
                sentences.append(text.split(". ")[0][:200].strip())
        body = ". ".join(sentences) if sentences else "(no content)"
        return Summary(
            thread_id=thread.thread_id,
            summary_text=f"Thread '{thread.subject}' with "
                         f"{thread.message_count} message(s): {body}",
            citations=citations_from_chunks(thread.chunks),
            model="mock",
        )
