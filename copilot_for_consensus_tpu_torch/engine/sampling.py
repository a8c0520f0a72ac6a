"""Token sampling: greedy / temperature / top-k / nucleus (port of the
JAX package's ``engine/sampling.py``).

Random draws come from an explicit ``torch.Generator``; they differ from
``jax.random``'s bits for the same seed, so sampled outputs compare by
distribution, greedy outputs token for token.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0      # 0 → greedy
    top_k: int = 0                # 0 → disabled
    top_p: float = 1.0            # 1 → disabled


def _filter_logits(logits: torch.Tensor,
                   cfg: SamplingConfig) -> torch.Tensor:
    """Temperature scaling + top-k / top-p masking over the last axis —
    the distribution every sampled token is drawn from. Callers guarantee
    ``cfg.temperature > 0``."""
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest prefix with cumulative mass ≥ top_p (the index
        # clamps where rounding leaves the total just under top_p).
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[..., None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplingConfig) -> torch.Tensor:
    """logits: [B, V] f32 → [B] int64 token ids."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits.float(), cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
