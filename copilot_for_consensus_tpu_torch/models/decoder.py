"""Decoder-only LLM (Mistral / Llama class) — port of the JAX package's
``models/decoder.py`` for the contiguous serving path.

Pre-norm transformer with RoPE, GQA, SwiGLU FFN and RMSNorm. Weights keep
the JAX layout — every layer leaf stacked on a leading layer axis — and
the ``lax.scan`` over that axis becomes a Python loop. Entry points:

* ``forward``               — [B, S] → logits [B, S, V] (scoring);
* ``prefill``               — writes the KV cache, returns last-position
  logits;
* ``decode_step_windowed``  — one token per slot against the read-only
  cache plus the dispatch's window buffer;
* ``merge_window``          — writes a window's KV into the cache, once.

``impl`` ("auto" | "plain") of ``forward`` and ``prefill`` selects the
kernel wrappers or their plain versions for every attention and int8
matmul of the pass; decode always goes through the wrappers.
"""

from __future__ import annotations

from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.models import layers as L
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import (
    init_random_quantized,
)

Params = dict[str, Any]


def init_params(cfg: DecoderConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None) -> Params:
    """Truncated-normal init scaled 1/sqrt(fan_in), norms at one, drawn
    on ``device`` (None → the card) from a generator seeded with
    ``seed``."""
    return init_random_quantized(cfg, seed=seed, dtype=dtype,
                                 device=resolve_device(device), leaves=())


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s leaves (views into the stacked tensors)."""
    return {k: ({kk: vv[li] for kk, vv in v.items()}
                if isinstance(v, dict) else v[li])
            for k, v in params["layers"].items()}


def _unembed(x: torch.Tensor, params: Params, cfg: DecoderConfig,
             impl: str = "auto") -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return (x @ params["tok_emb"].T).float()
    return L.qmatmul(x, params["lm_head"], impl).float()


def _block(x: torch.Tensor, layer: Params, cfg: DecoderConfig,
           lengths: torch.Tensor | None, impl: str):
    """One transformer block; returns (x, k, v) of the block."""
    h, k, v = L.attn_prefill(L.rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                             layer, cfg, lengths=lengths, impl=impl)
    x = x + h
    x = x + L.swiglu(L.rms_norm(x, layer["ffn_norm"], cfg.norm_eps),
                     layer, impl)
    return x, k, v


def forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            lengths: torch.Tensor | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Scoring pass: [B, S] int tokens → [B, S, V] f32 logits."""
    x = params["tok_emb"][tokens.long()]
    for li in range(cfg.n_layers):
        x, _, _ = _block(x, layer_params(params, li), cfg, lengths, impl)
    return _unembed(x, params, cfg, impl)


def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> Params:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
            cfg: DecoderConfig, cache: Params,
            impl: str = "auto") -> tuple[torch.Tensor, Params]:
    """Prompt pass. tokens: [B, S] right-padded; lengths: [B]. Writes kv
    for positions [0, S) into ``cache`` in place and returns
    (last-valid-position logits [B, V] f32, cache)."""
    b, s = tokens.shape
    x = params["tok_emb"][tokens.long()]
    for li in range(cfg.n_layers):
        x, k, v = _block(x, layer_params(params, li), cfg, lengths, impl)
        cache["k"][li, :, :, :s] = k
        cache["v"][li, :, :, :s] = v
    # Select each row's last valid hidden state BEFORE the lm_head, so
    # only B rows (not B·S) are unembedded.
    x_last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return _unembed(x_last, params, cfg, impl), cache


def decode_step_windowed(params: Params, tokens: torch.Tensor,
                         positions0: torch.Tensor, w: int,
                         cfg: DecoderConfig, cache: Params,
                         k_win: torch.Tensor, v_win: torch.Tensor,
                         kv_len: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One decode step that never writes the big cache.

    Fresh KV lives in the per-window buffers ``k_win``/``v_win``
    [L, B, Hkv, W, Dh] (the caller fills column ``w`` with this step's
    result) and reaches the cache once per window (``merge_window``).

    tokens: [B]; positions0: [B] dispatch-start positions; ``w``: step
    index in the window; ``kv_len`` bounds the cache prefix attention
    reads. Returns ([B, V] f32 logits, k_cols, v_cols [L, B, Hkv, Dh])."""
    x = params["tok_emb"][tokens.long()][:, None, :]        # [B, 1, D]
    k_pref, v_pref = cache["k"], cache["v"]
    if kv_len is not None and kv_len < k_pref.shape[3]:
        k_pref = k_pref[:, :, :, :kv_len]
        v_pref = v_pref[:, :, :, :kv_len]
    k_cols, v_cols = [], []
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h, k_cur, v_cur = L.attn_decode_windowed(
            L.rms_norm(x, layer["attn_norm"], cfg.norm_eps),
            layer, cfg, positions0, w, k_pref[li], v_pref[li],
            k_win[li], v_win[li])
        x = x + h
        x = x + L.swiglu(L.rms_norm(x, layer["ffn_norm"], cfg.norm_eps),
                         layer)
        k_cols.append(k_cur)
        v_cols.append(v_cur)
    return (_unembed(x, params, cfg)[:, 0], torch.stack(k_cols),
            torch.stack(v_cols))


def merge_window(cache: Params, k_win: torch.Tensor, v_win: torch.Tensor,
                 positions0: torch.Tensor, steps: int) -> Params:
    """Scatter a decode window's KV into the big cache, once, in place.

    k_win/v_win: [L, B, Hkv, W, Dh]; slot b's window columns land at
    cache positions ``positions0[b] + [0, steps)``. Columns at or past
    the cache extent are dropped (parked slots sit there)."""
    b, w = k_win.shape[1], k_win.shape[3]
    steps = min(steps, w)
    s_max = cache["k"].shape[3]
    dev = cache["k"].device
    bidx = torch.arange(b, device=dev)[:, None].expand(b, steps)
    pidx = positions0.to(dev).long()[:, None] + torch.arange(
        steps, device=dev)[None, :]
    keep = pidx < s_max
    bidx, pidx = bidx[keep], pidx[keep]
    for name, win in (("k", k_win), ("v", v_win)):
        # advanced indices on axes 1 and 3 put the [N] index axis first:
        # update shape [N, L, Hkv, Dh]
        upd = win[:, :, :, :steps].permute(1, 3, 0, 2, 4)[keep]
        cache[name][:, bidx, :, pidx, :] = upd.to(cache[name].dtype)
    return cache
