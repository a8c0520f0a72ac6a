"""Transformer building blocks (port of the JAX package's
``models/layers.py``, the parts the contiguous and paged serving paths
and the sentence encoder run).

Params are plain dicts of tensors; activations flow in the compute dtype
(bf16 by default) while norms, RoPE and softmax statistics run in f32.
``impl`` ("auto" | "plain") of the prefill functions picks between the
kernel wrappers and their plain versions, as in ``ops.attention.attention``;
decode always takes the wrappers. The ``_paged`` twins score the pool
piece through a ``partial_fn`` (K3 over the paged block pool) and fold
the dispatch-local pieces in with ``combine_partials``.

On a tp mesh the same functions run on a rank's weight shards at its
local widths (``decoder.local_config``: n_heads/tp q heads and their kv
heads, so GQA groups q head h with kv head h // (n_heads / n_kv_heads)
inside the rank); ``wo``'s and ``w_down``'s products are partial sums the
decoder completes with a tp all-reduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import (
    act_quant_mode,
    quant_kind,
)
from copilot_for_consensus_tpu_torch.ops.attention import (
    IMPLS,
    attention,
    causal_suffix_partial,
    combine_partials,
    decode_attention_prefix_window,
    decode_window_partial,
    prefill_attention_seeded,
)
from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

#: rows (the product of x's leading dims, bucket padding included) from
#: which an int8 leaf takes K4 in "a8" mode: int8 activations pay where the
#: matmul is bound by operations, in prefill waves; below it, in decode,
#: the weight bytes bound it and K2 serves (the JAX package's rule)
A8_MIN_ROWS = 1024

#: (weight-only, a8) routes of each leaf kind: (kernel wrapper, plain
#: version) pairs
_ROUTES = {
    "int4": ((qm.int4_matmul, qm.int4_matmul_ref),
             (qm.w4a8_matmul, qm.w4a8_matmul_ref)),
    "int8": ((qm.int8_matmul, qm.int8_matmul_ref),
             (qm.w8a8_matmul, qm.w8a8_matmul_ref)),
}


def qmatmul(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or a quantized leaf
    (``models.quant``). Routes, as the JAX package's ``qmatmul`` does on a
    TPU: int4 → K5, or K6 in "a8" mode (``quant.set_act_quant``); int8 →
    K2, or K4 in "a8" mode when x has at least ``A8_MIN_ROWS`` rows.
    ``impl="plain"`` takes the same route's plain versions; plain leaves go
    to ``torch.matmul``."""
    a8 = act_quant_mode() == "a8"
    if quant_kind(w) == "int8" and x.numel() // x.shape[-1] < A8_MIN_ROWS:
        a8 = False
    return _routed(x, w, impl, a8)


def wmatmul(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """``x @ w`` on the weight-only route whatever the activation mode:
    int8 → K2, int4 → K5 (``impl="plain"``: their plain versions); plain
    leaves go to ``torch.matmul``. The MoE experts' products, which the
    JAX package's ``_q_einsum`` keeps weight-only in "a8" mode too."""
    return _routed(x, w, impl, False)


def _routed(x: torch.Tensor, w, impl: str, a8: bool) -> torch.Tensor:
    kind = quant_kind(w)
    if kind is None:
        return x @ w
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    kernel, plain = _ROUTES[kind][a8]
    fn = kernel if impl == "auto" else plain
    return fn(x.contiguous(), w["q4" if kind == "int4" else "q"],
              w["scale"])


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics (the population variance, as
    ``jnp.var``), the output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


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
    if "wqkv" in layer:
        # fused int4 leaf (quant.fuse_int4_projections): one kernel call,
        # the product split by column
        nq, nkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        qkv = qmatmul(x, layer["wqkv"], impl)
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
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
                 lengths: torch.Tensor | None = None, impl: str = "auto",
                 attn_impl: str | None = None):
    """Full-sequence causal attention. Returns (out [B,S,D_model], k, v)
    with k/v in [B, Hkv, S, Dh] for cache insertion. ``attn_impl``
    overrides ``impl`` for the attention alone (None: ``impl``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(x, layer, cfg, positions, impl)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                  kv_lengths=lengths, impl=attn_impl or impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return qmatmul(o, layer["wo"], impl), k, v


def attn_decode_windowed(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
                         positions0: torch.Tensor, w: int,
                         k_pref_l: torch.Tensor, v_pref_l: torch.Tensor,
                         k_win_l: torch.Tensor, v_win_l: torch.Tensor,
                         kv_len: int | None = None,
                         k_done_l: torch.Tensor | None = None,
                         v_done_l: torch.Tensor | None = None):
    """Decode attention for one layer against (read-only prefix cache,
    completed windows of the dispatch, current window buffer, self).
    Returns (out, k_cur, v_cur); the caller stacks the per-layer k/v
    columns into the window buffer.

    positions0: [B] dispatch-start positions; ``w``: step index within
    the current window; ``k_done_l`` [B, Hkv, Wd, Dh] holds the dispatch's
    completed windows (absolute position = positions0 + Wd + w, for RoPE
    and the sliding-window mask)."""
    b = x.shape[0]
    n_done = 0 if k_done_l is None else k_done_l.shape[2]
    pos = (positions0 + n_done + w)[:, None]
    q, k, v = _project_qkv(x, layer, cfg, pos)
    k_cur = k[:, :, 0, :]
    v_cur = v[:, :, 0, :]
    o = decode_attention_prefix_window(
        q[:, :, 0, :], k_pref_l, v_pref_l, k_win_l, v_win_l,
        k_cur, v_cur, prefix_lengths=positions0, w=w,
        window=cfg.sliding_window, kv_len=kv_len, k_done=k_done_l,
        v_done=v_done_l)                                     # [B, Hq, Dh]
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return qmatmul(o, layer["wo"]), k_cur, v_cur


def attn_decode_windowed_paged(x: torch.Tensor, layer: dict,
                               cfg: DecoderConfig, positions0: torch.Tensor,
                               w: int, q_pos: torch.Tensor, partial_fn,
                               k_win_l: torch.Tensor, v_win_l: torch.Tensor,
                               k_done_l: torch.Tensor | None = None,
                               v_done_l: torch.Tensor | None = None):
    """Paged twin of :func:`attn_decode_windowed`: the committed prefix is
    never materialized — ``partial_fn(qg, lengths, q_pos)`` returns its
    flash (acc, m, l) straight off the block pool (K3), and the dispatch's
    local pieces (completed windows, current window, the token itself)
    fold in through one ``combine_partials``. Projections, RoPE and the
    output matmul are the contiguous twin's. ``q_pos`` = ``positions0 +
    Wd + w``, built once a step by the caller."""
    b = x.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(x, layer, cfg, q_pos[:, None])
    k_cur = k[:, :, 0, :]
    v_cur = v[:, :, 0, :]
    qg = q[:, :, 0, :].reshape(b, hkv, cfg.n_heads // hkv, dh).contiguous()
    pool_part = partial_fn(qg, positions0, q_pos)
    local_part = decode_window_partial(
        qg, k_win_l, v_win_l, k_cur, v_cur, positions0, w,
        window=cfg.sliding_window, k_done=k_done_l, v_done=v_done_l)
    o = combine_partials([pool_part, local_part], x.dtype)
    o = o.reshape(b, 1, cfg.n_heads * dh)
    return qmatmul(o, layer["wo"]), k_cur, v_cur


def attn_prefill_seeded(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
                        k_pref: torch.Tensor, v_pref: torch.Tensor,
                        prefix_lens: torch.Tensor,
                        lengths: torch.Tensor | None = None):
    """Suffix prefill against a seeded prefix held as an array (the
    contiguous slot cache): row b's tokens sit at absolute positions
    ``prefix_lens[b] + i`` (RoPE rotates with that offset) and attend
    (prefix KV ++ fresh causal suffix) in one joint softmax
    (``ops.attention.prefill_attention_seeded``). k_pref/v_pref:
    [B, Hkv, P, Dh]. Returns (out [B, S, D_model], k, v) with the fresh
    suffix k/v in [B, Hkv, S, Dh] for the cache write at the offset."""
    b, s, _ = x.shape
    positions = prefix_lens[:, None] + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(x, layer, cfg, positions)
    o = prefill_attention_seeded(q, k, v, k_pref, v_pref, prefix_lens,
                                 kv_lengths=lengths)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return qmatmul(o, layer["wo"]), k, v


def attn_prefill_seeded_paged(x: torch.Tensor, layer: dict,
                              cfg: DecoderConfig, partial_fn,
                              prefix_lens: torch.Tensor,
                              lengths: torch.Tensor | None = None):
    """Suffix prefill against a prefix held in the block pool: row b's
    tokens sit at absolute positions ``prefix_lens[b] + i`` (RoPE rotates
    with that offset). ``partial_fn(q_rows, lengths, q_pos)`` scores the
    prefix in place (K3 over R = G·S rows, (g, s) flattened row-major) and
    the fresh causal suffix joins through ``combine_partials``. Returns
    (out [B, S, D_model], k, v) with the fresh suffix k/v in
    [B, Hkv, S, Dh] for the pool scatter at the per-row offset."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = prefix_lens[:, None] + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(x, layer, cfg, positions)
    q_rows = q.reshape(b, hkv, (hq // hkv) * s, dh).contiguous()
    pool_part = partial_fn(q_rows, prefix_lens, prefix_lens)
    suffix_part = causal_suffix_partial(q, k, v, kv_lengths=lengths)
    o = combine_partials([pool_part, suffix_part], x.dtype)
    # the f32 partials (128 MiB each at B 8, R 4096) are dead past the fold
    del pool_part, suffix_part
    o = o.reshape(b, hq, s, dh).transpose(1, 2).reshape(b, s, hq * dh)
    return qmatmul(o, layer["wo"]), k, v


def swiglu(x: torch.Tensor, layer: dict, impl: str = "auto") -> torch.Tensor:
    """SwiGLU MLP: silu(x·Wg) ⊙ (x·Wu) · Wd — Llama/Mistral family FFN."""
    if "w_gu" in layer:
        # fused int4 gate+up: one kernel call, split by column
        gu = qmatmul(x, layer["w_gu"], impl).float()
        f = gu.shape[-1] // 2
        gate, up = F.silu(gu[..., :f]), gu[..., f:]
    else:
        gate = F.silu(qmatmul(x, layer["w_gate"], impl).float())
        up = qmatmul(x, layer["w_up"], impl).float()
    return qmatmul((gate * up).to(x.dtype), layer["w_down"], impl)


def gelu_mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """BERT-style 2-layer GELU MLP (the encoder's FFN). Exact (erf) GELU,
    the BERT family's ``hidden_act="gelu"``: the tanh approximation would
    break checkpoint parity. The GELU runs in f32."""
    h = F.gelu((x @ layer["w_in"] + layer["b_in"]).float(),
               approximate="none")
    return h.to(x.dtype) @ layer["w_out"] + layer["b_out"]
