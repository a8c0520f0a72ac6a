"""Bidirectional sentence encoder (MiniLM/BERT class) → text embeddings
(port of the JAX package's ``models/encoder.py``).

Post-norm transformer with learned positions, exact-erf GELU MLP, masked
mean pooling and L2 normalisation — the architecture class of
all-MiniLM-L6-v2. [B, S] tokens in, [B, d_model] f32 vectors out, one
pass for the whole batch. Attention goes through ``ops.attention
.attention(causal=False, kv_lengths=)``, which is K1 on the card (at
``minilm-l6``'s head dim 32, K1's CUDA-core body); the projections are
plain ``torch.matmul``, as they are plain XLA in the JAX package. The
layers run in a Python loop over the stacked leaves (the JAX package's
``lax.scan``). ``logical_axes`` comes with the port's sharding (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.models import layers as L
from copilot_for_consensus_tpu_torch.models.configs import EncoderConfig
from copilot_for_consensus_tpu_torch.models.quant import _trunc_normal
from copilot_for_consensus_tpu_torch.ops.attention import attention

Params = dict[str, Any]


def init_params(cfg: EncoderConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None) -> Params:
    """The JAX package's leaves and shapes: truncated normal in [-2, 2]
    scaled 1/sqrt(fan_in) for the embeddings and projections, biases at
    zero, norms at one — drawn on ``device`` (None → the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size

    def dense(shape, fan_in):
        return _trunc_normal(shape, fan_in, dtype, device, gen)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "tok_emb": dense((v, d), d),
        "pos_emb": dense((cfg.max_positions, d), d),
        "emb_norm_w": full((d,), 1.0),
        "emb_norm_b": full((d,), 0.0),
        "layers": {
            "wq": dense((n, d, d), d),
            "wk": dense((n, d, d), d),
            "wv": dense((n, d, d), d),
            "wo": dense((n, d, d), d),
            "wq_b": full((n, d), 0.0),
            "wk_b": full((n, d), 0.0),
            "wv_b": full((n, d), 0.0),
            "wo_b": full((n, d), 0.0),
            "attn_norm_w": full((n, d), 1.0),
            "attn_norm_b": full((n, d), 0.0),
            "w_in": dense((n, d, f), d),
            "b_in": full((n, f), 0.0),
            "w_out": dense((n, f, d), f),
            "b_out": full((n, d), 0.0),
            "ffn_norm_w": full((n, d), 1.0),
            "ffn_norm_b": full((n, d), 0.0),
        },
    }


def encode(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
           cfg: EncoderConfig, attn_impl: str = "auto") -> torch.Tensor:
    """tokens: [B, S] right-padded; lengths: [B] (each ≥ 1) → [B, d_model]
    f32, L2-normalised (cosine-ready, matching sentence-transformers).
    ``attn_impl``: "auto" → K1's wrapper, "plain" → K1's plain version."""
    b, s = tokens.shape
    if s > cfg.max_positions:
        raise ValueError(
            f"sequence length {s} exceeds max_positions "
            f"{cfg.max_positions}; the caller must truncate or window"
        )
    dh = cfg.head_dim
    lengths = lengths.to(torch.int32)
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][:s][None]
    x = L.layer_norm(x, params["emb_norm_w"], params["emb_norm_b"],
                     cfg.norm_eps)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, cfg.n_heads, dh).transpose(1, 2)

    stacked = params["layers"]
    for li in range(cfg.n_layers):
        layer = {k: w[li] for k, w in stacked.items()}
        q = heads(x @ layer["wq"] + layer["wq_b"])
        k = heads(x @ layer["wk"] + layer["wk_b"])
        v = heads(x @ layer["wv"] + layer["wv_b"])
        o = attention(q, k, v, causal=False, kv_lengths=lengths,
                      impl=attn_impl)
        o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
        x = L.layer_norm(x + o @ layer["wo"] + layer["wo_b"],
                         layer["attn_norm_w"], layer["attn_norm_b"],
                         cfg.norm_eps)
        h = L.gelu_mlp(x, layer)
        x = L.layer_norm(x + h, layer["ffn_norm_w"], layer["ffn_norm_b"],
                         cfg.norm_eps)

    # masked mean pooling over valid positions, then L2 normalise
    mask = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
    xf = x.float() * mask[..., None]
    pooled = xf.sum(dim=1) / lengths[:, None].float().clamp_min(1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)
