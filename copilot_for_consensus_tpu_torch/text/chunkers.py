"""Chunking strategies: message text → token-bounded retrieval units.

Capability parity with the reference's ``copilot_chunking`` package
(``chunkers.py``: TokenWindowChunker ``:101`` with size 384 / overlap 50 /
min 100 / max 512, FixedSizeChunker ``:213``, SemanticChunker ``:352``,
``create_chunker`` ``:478``).

Token counts here use the same fast estimator the orchestrator budgets with
(``estimate_tokens``, ~1.3 tokens/word — reference
``orchestrator/app/context_selectors.py:17,156``), so chunk budgets and
context budgets agree end to end. The TPU embedding path re-tokenizes with
the real BPE vocabulary; the estimator only shapes chunk boundaries.
"""

from __future__ import annotations

import abc
import re
from dataclasses import dataclass, field
from typing import Any

TOKENS_PER_WORD = 1.3

_WORD_RE = re.compile(r"\S+")
_PARAGRAPH_SPLIT = re.compile(r"\n\s*\n")
_SENTENCE_SPLIT = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(])")


def estimate_tokens(text: str) -> int:
    return int(len(_WORD_RE.findall(text or "")) * TOKENS_PER_WORD)


@dataclass
class Chunk:
    seq: int
    text: str
    token_count: int
    metadata: dict[str, Any] = field(default_factory=dict)


class Chunker(abc.ABC):
    name = "base"

    @abc.abstractmethod
    def chunk(self, text: str) -> list[Chunk]: ...


@dataclass
class _WindowParams:
    chunk_size: int = 384       # target tokens per chunk
    overlap: int = 50           # tokens shared between adjacent chunks
    min_chunk_tokens: int = 100  # trailing chunks below this merge backward
    max_chunk_tokens: int = 512


class TokenWindowChunker(Chunker):
    """Sliding token window with overlap — the default chunker."""

    name = "token_window"

    def __init__(self, chunk_size: int = 384, overlap: int = 50,
                 min_chunk_tokens: int = 100, max_chunk_tokens: int = 512):
        if overlap >= chunk_size:
            raise ValueError("overlap must be < chunk_size")
        self.p = _WindowParams(chunk_size, overlap, min_chunk_tokens,
                               max_chunk_tokens)

    def chunk(self, text: str) -> list[Chunk]:
        words = _WORD_RE.findall(text or "")
        if not words:
            return []
        words_per_chunk = max(1, int(self.p.chunk_size / TOKENS_PER_WORD))
        overlap_words = int(self.p.overlap / TOKENS_PER_WORD)
        step = max(1, words_per_chunk - overlap_words)

        chunks: list[Chunk] = []
        start = 0
        while start < len(words):
            piece = words[start:start + words_per_chunk]
            chunk_text = " ".join(piece)
            tokens = estimate_tokens(chunk_text)
            is_tail = start + words_per_chunk >= len(words)
            if (chunks and is_tail and tokens < self.p.min_chunk_tokens
                    and chunks[-1].token_count + tokens <= self.p.max_chunk_tokens):
                # Merge a small FINAL piece into the previous chunk.
                # The tail check matters: when min_chunk_tokens exceeds
                # chunk_size, every window is "small" — merging a
                # mid-stream window and stopping would drop the words
                # past it (found by the chunker fuzz harness).
                merged = chunks[-1].text + " " + chunk_text
                chunks[-1] = Chunk(chunks[-1].seq, merged,
                                   estimate_tokens(merged))
                break
            chunks.append(Chunk(len(chunks), chunk_text, tokens))
            if is_tail:
                break
            start += step
        return chunks


class FixedSizeChunker(Chunker):
    """Fixed character-window chunking (no token estimation)."""

    name = "fixed_size"

    def __init__(self, chunk_chars: int = 1500, overlap_chars: int = 200):
        if overlap_chars >= chunk_chars:
            raise ValueError("overlap_chars must be < chunk_chars")
        self.chunk_chars = chunk_chars
        self.overlap_chars = overlap_chars

    def chunk(self, text: str) -> list[Chunk]:
        text = (text or "").strip()
        if not text:
            return []
        step = self.chunk_chars - self.overlap_chars
        chunks = []
        for i, start in enumerate(range(0, len(text), step)):
            piece = text[start:start + self.chunk_chars]
            if not piece.strip():
                break
            chunks.append(Chunk(i, piece, estimate_tokens(piece)))
            if start + self.chunk_chars >= len(text):
                break
        return chunks


class SemanticChunker(Chunker):
    """Paragraph/sentence-boundary chunking under a token budget.

    Packs whole paragraphs up to ``chunk_size`` tokens; paragraphs larger
    than the budget are split at sentence boundaries.
    """

    name = "semantic"

    def __init__(self, chunk_size: int = 384, min_chunk_tokens: int = 32):
        self.chunk_size = chunk_size
        self.min_chunk_tokens = min_chunk_tokens

    def _units(self, text: str) -> list[str]:
        units = []
        for para in _PARAGRAPH_SPLIT.split(text or ""):
            para = para.strip()
            if not para:
                continue
            if estimate_tokens(para) > self.chunk_size:
                units.extend(s.strip() for s in _SENTENCE_SPLIT.split(para)
                             if s.strip())
            else:
                units.append(para)
        return units

    def chunk(self, text: str) -> list[Chunk]:
        chunks: list[Chunk] = []
        current: list[str] = []
        current_tokens = 0
        for unit in self._units(text):
            unit_tokens = estimate_tokens(unit)
            if current and current_tokens + unit_tokens > self.chunk_size:
                body = "\n\n".join(current)
                chunks.append(Chunk(len(chunks), body, estimate_tokens(body)))
                current, current_tokens = [], 0
            current.append(unit)
            current_tokens += unit_tokens
        if current:
            body = "\n\n".join(current)
            tokens = estimate_tokens(body)
            if (chunks and tokens < self.min_chunk_tokens):
                merged = chunks[-1].text + "\n\n" + body
                chunks[-1] = Chunk(chunks[-1].seq, merged,
                                   estimate_tokens(merged))
            else:
                chunks.append(Chunk(len(chunks), body, tokens))
        return chunks


def create_chunker(config: Any = None) -> Chunker:
    cfg = dict(config or {})
    driver = cfg.get("driver", "token_window")
    if driver == "token_window":
        return TokenWindowChunker(
            chunk_size=int(cfg.get("chunk_size", 384)),
            overlap=int(cfg.get("overlap", 50)),
            min_chunk_tokens=int(cfg.get("min_chunk_tokens", 100)),
            max_chunk_tokens=int(cfg.get("max_chunk_tokens", 512)),
        )
    if driver == "fixed_size":
        return FixedSizeChunker(
            chunk_chars=int(cfg.get("chunk_chars", 1500)),
            overlap_chars=int(cfg.get("overlap_chars", 200)),
        )
    if driver == "semantic":
        return SemanticChunker(
            chunk_size=int(cfg.get("chunk_size", 384)),
            min_chunk_tokens=int(cfg.get("min_chunk_tokens", 32)),
        )
    raise ValueError(f"unknown chunker driver {driver!r}")
