"""Consensus detection over discussion threads.

Reference surface: ``copilot_consensus/consensus.py`` —
ConsensusLevel/Signal (``:33,45``), detector ABC (``:68``),
HeuristicConsensusDetector with agreement/disagreement regex patterns and
thresholds (``:90,126,167``), Mock (``:290``), ML stub (``:351``),
factory (``:399``). Here the ML detector is TPU-real: it scores
agreement via the first-party embedding encoder (cosine similarity to
anchor statements) instead of an unimplemented stub.
"""

from __future__ import annotations

import abc
import enum
import re
from dataclasses import dataclass, field
from typing import Any, Sequence


class ConsensusLevel(enum.Enum):
    STRONG_CONSENSUS = "strong_consensus"
    ROUGH_CONSENSUS = "rough_consensus"
    CONTESTED = "contested"
    NO_SIGNAL = "no_signal"


@dataclass
class ConsensusSignal:
    level: ConsensusLevel
    score: float                       # [-1, 1]: -1 contested, +1 agreement
    agree_count: int = 0
    disagree_count: int = 0
    evidence: list[str] = field(default_factory=list)


class ConsensusDetector(abc.ABC):
    @abc.abstractmethod
    def detect(self, messages: Sequence[dict[str, Any]]) -> ConsensusSignal:
        """messages: dicts with at least ``body`` (and optionally
        ``from_addr``)."""


_AGREE_PATTERNS = [
    r"(?:^|[\s(])\+1\b", r"\bagree[sd]?\b", r"\bsounds good\b", r"\blgtm\b",
    r"\bsupport (?:this|the) (?:proposal|draft|change)\b",
    r"\bno objection[s]?\b", r"\bworks for me\b", r"\bin favou?r\b",
    r"\bship it\b", r"\bconsensus\b",
]
_DISAGREE_PATTERNS = [
    r"(?:^|[\s(])-1\b", r"\bdisagree[sd]?\b", r"\bobject(?:ion[s]?|s|ed)?\b",
    r"\boppose[sd]?\b", r"\bconcern(?:s|ed)?\b", r"\bproblematic\b",
    r"\bblock(?:ing|er)?\b", r"\bstrongly against\b", r"\bbroken\b",
]


def _signal_from_counts(agree: int, disagree: int, evidence: list[str],
                        strong: float, rough: float,
                        min_signals: int) -> ConsensusSignal:
    total = agree + disagree
    if total < min_signals:
        return ConsensusSignal(ConsensusLevel.NO_SIGNAL, 0.0, agree,
                               disagree, evidence)
    ratio = agree / total
    score = 2.0 * ratio - 1.0
    level = (ConsensusLevel.STRONG_CONSENSUS if ratio >= strong
             else ConsensusLevel.ROUGH_CONSENSUS if ratio >= rough
             else ConsensusLevel.CONTESTED)
    return ConsensusSignal(level, score, agree, disagree, evidence)


class HeuristicConsensusDetector(ConsensusDetector):
    """Regex vote counting with thresholds (reference ``:90-167``)."""

    def __init__(self, strong_threshold: float = 0.8,
                 rough_threshold: float = 0.55, min_signals: int = 2):
        self.strong_threshold = strong_threshold
        self.rough_threshold = rough_threshold
        self.min_signals = min_signals
        self._agree = [re.compile(p, re.I) for p in _AGREE_PATTERNS]
        self._disagree = [re.compile(p, re.I) for p in _DISAGREE_PATTERNS]

    def detect(self, messages: Sequence[dict[str, Any]]) -> ConsensusSignal:
        agree, disagree, evidence = 0, 0, []
        for msg in messages:
            body = (msg.get("body") or "")
            a = sum(1 for p in self._agree if p.search(body))
            d = sum(1 for p in self._disagree if p.search(body))
            if a > d:
                agree += 1
                evidence.append(f"agree: {body.strip()[:80]}")
            elif d > a:
                disagree += 1
                evidence.append(f"disagree: {body.strip()[:80]}")
        return _signal_from_counts(agree, disagree, evidence,
                                   self.strong_threshold,
                                   self.rough_threshold, self.min_signals)


class MockConsensusDetector(ConsensusDetector):
    def __init__(self, level: ConsensusLevel = ConsensusLevel.NO_SIGNAL,
                 score: float = 0.0):
        self.level = level
        self.score = score

    def detect(self, messages):
        return ConsensusSignal(self.level, self.score)


class EmbeddingConsensusDetector(ConsensusDetector):
    """TPU-ML detector: scores each message by cosine similarity of its
    embedding to agreement/disagreement anchor sentences, then applies the
    heuristic thresholds. Where the reference's MLConsensusDetector is an
    unimplemented stub (``consensus.py:351``), this one runs."""

    _AGREE_ANCHOR = "I agree, this sounds good, +1, support the proposal"
    _DISAGREE_ANCHOR = ("I disagree, objection, this is problematic, "
                        "concerns, -1")

    def __init__(self, embedding_provider, strong_threshold: float = 0.8,
                 rough_threshold: float = 0.55, min_signals: int = 2,
                 margin: float = 0.05):
        self.provider = embedding_provider
        self.margin = margin
        self._thresholds = (strong_threshold, rough_threshold, min_signals)
        anchors = self.provider.embed_batch(
            [self._AGREE_ANCHOR, self._DISAGREE_ANCHOR])
        self._agree_vec, self._disagree_vec = anchors

    @staticmethod
    def _dot(a, b) -> float:
        return float(sum(x * y for x, y in zip(a, b)))

    def detect(self, messages: Sequence[dict[str, Any]]) -> ConsensusSignal:
        strong, rough, min_signals = self._thresholds
        agree, disagree, evidence = 0, 0, []
        bodies = [(msg.get("body") or "") for msg in messages]
        vecs = self.provider.embed_batch(bodies) if bodies else []
        for body, vec in zip(bodies, vecs):
            sa = self._dot(vec, self._agree_vec)
            sd = self._dot(vec, self._disagree_vec)
            if sa - sd > self.margin:
                agree += 1
                evidence.append(f"agree({sa - sd:.2f}): {body[:60]}")
            elif sd - sa > self.margin:
                disagree += 1
                evidence.append(f"disagree({sd - sa:.2f}): {body[:60]}")
        return _signal_from_counts(agree, disagree, evidence, strong,
                                   rough, min_signals)


def create_consensus_detector(config: Any = None, **kwargs: Any
                              ) -> ConsensusDetector:
    driver = "heuristic"
    if config is not None:
        driver = (config.get("driver", "heuristic")
                  if isinstance(config, dict)
                  else getattr(config, "driver", "heuristic"))
    if driver == "heuristic":
        return HeuristicConsensusDetector()
    if driver == "mock":
        return MockConsensusDetector()
    if driver == "embedding":
        provider = kwargs.get("embedding_provider")
        if provider is None:
            raise ValueError("embedding driver needs embedding_provider=")
        return EmbeddingConsensusDetector(provider)
    raise ValueError(f"unknown consensus_detector driver {driver!r}")


from copilot_for_consensus_tpu_torch.core.factory import register_driver  # noqa: E402

for _name in ("heuristic", "mock", "embedding"):
    register_driver("consensus_detector", _name, create_consensus_detector)
