"""Transformer building blocks (port of the JAX package's
``models/layers.py``, the parts the contiguous serving path runs).

Params are plain dicts of tensors; activations flow in the compute dtype
(bf16 by default) while norms, RoPE and softmax statistics run in f32.
``impl`` ("auto" | "plain") of the prefill functions picks between the
kernel wrappers and their plain versions, as in ``ops.attention.attention``;
decode always takes the wrappers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import quant_kind
from copilot_for_consensus_tpu_torch.ops.attention import (
    IMPLS,
    attention,
    decode_attention_prefix_window,
)
from copilot_for_consensus_tpu_torch.ops.quant_matmul import (
    int8_matmul,
    int8_matmul_ref,
)


def qmatmul(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or an int8 leaf
    ``{"q", "scale"}``. int8 leaves go to K2 (``impl="auto"``) or its
    plain version (``impl="plain"``); plain leaves go to ``torch.matmul``."""
    kind = quant_kind(w)
    if kind is None:
        return x @ w
    if kind != "int8":
        raise NotImplementedError(f"{kind} leaves are not ported yet")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    fn = int8_matmul if impl == "auto" else int8_matmul_ref
    return fn(x.contiguous(), w["q"], w["scale"])


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


# Rotary position embedding (GPT-NeoX rotate-half convention, as used by
# Llama / Mistral), computed in f32.


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                     # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] (int) → same shape, rotated."""
    angles = positions[..., None].float() * inv_freq          # [B,S,D/2]
    cos = torch.cos(angles)[:, None]                          # [B,1,S,D/2]
    sin = torch.sin(angles)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _project_qkv(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
                 positions: torch.Tensor, impl: str = "auto"):
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = qmatmul(x, layer["wq"], impl)
    k = qmatmul(x, layer["wk"], impl)
    v = qmatmul(x, layer["wv"], impl)
    q = q.reshape(b, s, cfg.n_heads, dh).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    inv_freq = rope_frequencies(dh, cfg.rope_theta, device=x.device)
    return (apply_rope(q, positions, inv_freq),
            apply_rope(k, positions, inv_freq), v)


def attn_prefill(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
                 lengths: torch.Tensor | None = None, impl: str = "auto"):
    """Full-sequence causal attention. Returns (out [B,S,D_model], k, v)
    with k/v in [B, Hkv, S, Dh] for cache insertion."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(x, layer, cfg, positions, impl)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                  kv_lengths=lengths, impl=impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return qmatmul(o, layer["wo"], impl), k, v


def attn_decode_windowed(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
                         positions0: torch.Tensor, w: int,
                         k_pref_l: torch.Tensor, v_pref_l: torch.Tensor,
                         k_win_l: torch.Tensor, v_win_l: torch.Tensor,
                         kv_len: int | None = None):
    """Decode attention for one layer against (read-only prefix cache,
    current window buffer, self). Returns (out, k_cur, v_cur); the caller
    stacks the per-layer k/v columns into the window buffer.

    positions0: [B] dispatch-start positions; ``w``: step index within
    the window (absolute position = positions0 + w)."""
    b = x.shape[0]
    pos = (positions0 + w)[:, None]
    q, k, v = _project_qkv(x, layer, cfg, pos)
    k_cur = k[:, :, 0, :]
    v_cur = v[:, :, 0, :]
    o = decode_attention_prefix_window(
        q[:, :, 0, :], k_pref_l, v_pref_l, k_win_l, v_win_l,
        k_cur, v_cur, prefix_lengths=positions0, w=w,
        window=cfg.sliding_window, kv_len=kv_len)            # [B, Hq, Dh]
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return qmatmul(o, layer["wo"]), k_cur, v_cur


def swiglu(x: torch.Tensor, layer: dict, impl: str = "auto") -> torch.Tensor:
    """SwiGLU MLP: silu(x·Wg) ⊙ (x·Wu) · Wd — Llama/Mistral family FFN."""
    gate = F.silu(qmatmul(x, layer["w_gate"], impl).float())
    up = qmatmul(x, layer["w_up"], impl).float()
    return qmatmul((gate * up).to(x.dtype), layer["w_down"], impl)
