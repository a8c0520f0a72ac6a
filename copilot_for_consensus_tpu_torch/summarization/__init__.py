"""Summarizer adapter (reference: ``adapters/copilot_summarization``).

Drivers: ``tpu`` (first-party continuous-batching GenerationEngine — the
replacement for Ollama/llama.cpp/OpenAI, ``factory.py:89-94`` of the
reference) and ``mock`` (extractive, parity with ``mock_summarizer.py:17``).
"""

from copilot_for_consensus_tpu_torch.summarization.base import (
    Citation,
    MockSummarizer,
    RateLimitError,
    Summarizer,
    Summary,
    ThreadContext,
)
from copilot_for_consensus_tpu_torch.summarization.factory import create_summarizer

__all__ = [
    "Citation",
    "MockSummarizer",
    "RateLimitError",
    "Summarizer",
    "Summary",
    "ThreadContext",
    "create_summarizer",
]
