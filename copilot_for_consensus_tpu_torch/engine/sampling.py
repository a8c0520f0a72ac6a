"""Token sampling: greedy / temperature / top-k / nucleus, and the
speculative verify dispatch's draft acceptance (port of the JAX
package's ``engine/sampling.py``).

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


def verify_draft(logits: torch.Tensor, draft: torch.Tensor,
                 draft_lens: torch.Tensor,
                 generator: torch.Generator | None,
                 cfg: SamplingConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact acceptance of prompt-lookup drafts over one verify dispatch.

    ``logits``: [B, S, V] raw model logits at the S = k_max+1 scored
    positions — row j is the distribution of the token FOLLOWING fed
    token j (token 0 is the stream's committed next token, tokens 1..k
    its draft). ``draft``: [B, S-1] proposed tokens, right-padded;
    ``draft_lens``: [B] valid draft counts per row (0 = the row rides the
    dispatch as a plain single decode step).

    Returns ``(tokens_out [B, S] int64, n_accept [B] int64)``: row b emits
    ``tokens_out[b, :n_accept[b] + 1]`` — the accepted draft tokens, then
    one model-sampled token (the correction at the first rejection, or the
    bonus token after a fully accepted draft). Columns past that are
    garbage.

    Greedy (``temperature <= 0``): accept while the argmax matches the
    draft, so the emitted tokens are the argmax chain itself —
    bit-identical to stepwise greedy decode. Sampled: the rejection rule
    with a point-mass draft — accept d with probability p(d) under the
    FILTERED serving distribution p, else resample from p with d removed
    (renormalized) — which leaves every emitted token distributed exactly
    as p. The draws come from ``generator``."""
    b, s, v = logits.shape
    dev = logits.device
    draft = draft.to(dev).long()
    within = (torch.arange(s - 1, device=dev)[None, :]
              < draft_lens.to(dev)[:, None])                 # [B, S-1]
    if cfg.temperature <= 0.0:
        out = torch.argmax(logits, dim=-1)                   # [B, S]
        ok = (out[:, :-1] == draft) & within
        return out, torch.cumprod(ok.long(), dim=1).sum(dim=1)
    p = torch.softmax(_filter_logits(logits.float(), cfg), dim=-1)
    p_draft = torch.gather(p[:, :-1], -1, draft[..., None])[..., 0]
    u = torch.rand((b, s - 1), generator=generator, device=dev)
    ok = (u < p_draft) & within
    n_accept = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    # Correction draw at a rejection: p with the drafted token removed
    # (multinomial renormalizes). A p(d) = 1 point mass never rejects; its
    # empty row draws from p instead, and the draw is unused.
    res_p = p[:, :-1].scatter(-1, draft[..., None], 0.0)
    res_p = torch.where(res_p.sum(-1, keepdim=True) > 0, res_p, p[:, :-1])
    res = torch.multinomial(res_p.reshape(-1, v), 1,
                            generator=generator).reshape(b, s - 1)
    # Plain draw from p: the bonus token after a fully accepted draft, and
    # what a 0-draft row emits (``sample``'s draw).
    plain = torch.multinomial(p.reshape(-1, v), 1,
                              generator=generator).reshape(b, s)
    head = torch.where(within, torch.where(ok, draft, res), plain[:, :-1])
    return torch.cat([head, plain[:, -1:]], dim=1), n_accept
