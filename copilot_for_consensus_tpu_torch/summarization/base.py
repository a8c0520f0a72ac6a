"""Summarizer ABC and domain models (the port's own copy).

Copied from the JAX package's ``summarization/base.py``. Citations are
derived from the retrieved chunks, not parsed out of LLM output.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Any


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
