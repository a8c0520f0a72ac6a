"""Decoder-only LLM (Mistral / Llama class) — port of the JAX package's
``models/decoder.py`` for the contiguous and paged serving paths.

Pre-norm transformer with RoPE, GQA, SwiGLU FFN (or Mixtral-class
experts, ``models/moe.py``, when the config has them) and RMSNorm. Weights keep
the JAX layout — every layer leaf stacked on a leading layer axis — and
the ``lax.scan`` over that axis becomes a Python loop. Entry points:

* ``forward``               — [B, S] → logits [B, S, V] (scoring);
* ``prefill``               — writes the KV cache, returns last-position
  logits;
* ``decode_step_windowed``  — one token per slot against the read-only
  cache plus the dispatch's window buffer;
* ``merge_window``          — writes a window's KV into the cache, once;
* ``prefill_seeded``        — the contiguous prefix cache's suffix pass
  against prefix KV gathered from its block pool;
* ``decode_step_piggyback`` / ``merge_prefill`` — one decode step that
  also prefills packed prompt chunks (piggyback prefill), and the write of
  those chunks' KV into the cache;
* ``verify_seeded``        — the contiguous engine's seeded pass over its
  slots (speculative verify, chunked prefill), every position's logits;
* ``decode_step_windowed_paged`` / ``prefill_seeded_paged`` — the paged
  engine's decode step and seeded pass (admission, chunk, verify with
  ``all_logits``): the KV held in the block
  pool is scored in place by a ``partial_fn(li, q_rows, lengths, q_pos)``
  (K3), handed the layer index ``li`` as an int offset into the stacked
  pool, so no per-layer pool slice is copied.

``impl`` ("auto" | "plain") of ``forward`` and ``prefill`` selects the
kernel wrappers or their plain versions for every attention and int8
matmul of the pass; decode always goes through the wrappers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields, replace
from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import (
    resolve_device,
    storage_view,
    zeros,
)
from copilot_for_consensus_tpu_torch.models import layers as L
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.moe import moe_ffn
from copilot_for_consensus_tpu_torch.models.quant import (
    init_random_quantized,
    quant_kind,
    quantize_logical_axes,
)
from copilot_for_consensus_tpu_torch.ops.attention import (
    decode_attention_prefix_window,
)
from copilot_for_consensus_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from copilot_for_consensus_tpu_torch.parallel.collectives import (
    all_gather_last,
    all_reduce,
)

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# tensor parallelism (megatron-style, as the JAX package's DEFAULT_RULES
# lay it out): q/k/v and gate/up column-parallel, wo and w_down
# row-parallel with an all-reduce after each (the JAX decoder's ``reduce``
# hook), the token embedding and the lm_head vocab-parallel. A rank runs
# the passes below over its shard of the weights with a ``local_config``
# (its head and ffn widths, and its ``TPShard``); a config with no shard —
# one rank on tp — makes every hook the identity, launching nothing.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TPShard:
    """This rank's place on the tp axis: the group the partial products
    are reduced over, and the first token id of its vocab rows."""

    group: Any
    vocab_start: int


@dataclass(frozen=True)
class LocalConfig(DecoderConfig):
    """A config at one tp rank's widths (``local_config``), carrying the
    rank's ``TPShard``: the passes given it reduce over tp."""

    tp: TPShard | None = None


def _embed(params: Params, tokens: torch.Tensor,
           cfg: DecoderConfig) -> torch.Tensor:
    """The token embedding; vocab-parallel under tp: ids outside this
    rank's rows give zero rows, and the all-reduce sums the one rank's row
    that holds each id."""
    emb = params["tok_emb"]
    tp = getattr(cfg, "tp", None)
    if tp is None:
        return emb[tokens.long()]
    ids = tokens.long() - tp.vocab_start
    mine = (ids >= 0) & (ids < emb.shape[0])
    x = emb[ids.clamp(0, emb.shape[0] - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return all_reduce(x, tp.group)


def _reduce(h: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """A row-parallel product's partial sum completed over tp (the JAX
    decoder's ``reduce`` hook); the identity without a shard."""
    tp = getattr(cfg, "tp", None)
    return h if tp is None else all_reduce(h, tp.group)


def logical_axes(cfg: DecoderConfig) -> Params:
    """Same structure as params; leaves are logical-axis tuples (the JAX
    package's)."""
    layer = {
        "attn_norm": (None, "norm"),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "kv_heads"),
        "wv": (None, "embed", "kv_heads"),
        "wo": (None, "heads", "embed"),
        "ffn_norm": (None, "norm"),
    }
    if cfg.is_moe:
        layer.update({
            "router": (None, "embed", None),
            "w_gate": (None, "experts", "embed", "expert_ffn"),
            "w_up": (None, "experts", "embed", "expert_ffn"),
            "w_down": (None, "experts", "expert_ffn", "embed"),
        })
    else:
        layer.update({
            "w_gate": (None, "embed", "ffn"),
            "w_up": (None, "embed", "ffn"),
            "w_down": (None, "ffn", "embed"),
        })
    axes: Params = {
        "tok_emb": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("norm",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def cache_logical_axes() -> Params:
    return {"k": (None, "batch", "kv_heads", None, None),
            "v": (None, "batch", "kv_heads", None, None)}


def param_logical_axes(cfg: DecoderConfig, params: Params) -> Params:
    """:func:`logical_axes` shaped like ``params``: quantized leaves get
    their ``q``/``q4`` and ``scale`` axes (``quant.quantize_logical_axes``,
    the mode read off the tree). Fused int4 leaves have no axes: a tree is
    sharded before it is fused."""
    axes = logical_axes(cfg)
    layers_t = params.get("layers", {})
    if "wqkv" in layers_t or "w_gu" in layers_t:
        raise ValueError("fused int4 leaves (wqkv, w_gu) cannot be sharded: "
                         "shard the unfused tree, then fuse")
    kinds = {quant_kind(v) for v in layers_t.values()} - {None}
    if len(kinds) > 1:
        raise ValueError(f"mixed quantized leaf kinds {sorted(kinds)}")
    if kinds:
        axes = quantize_logical_axes(axes, mode=kinds.pop())
    return axes


def local_config(cfg: DecoderConfig, tp: int, rules,
                 shard: TPShard | None = None) -> DecoderConfig:
    """The widths one rank of a tp-``tp`` mesh runs under ``rules``
    (``parallel.sharding.serving_param_rules``): n_heads/tp, n_kv_heads/tp
    (where kv heads are replicated, the one kv head this rank's q heads
    group to), d_ff/tp; head_dim and the vocab stay whole. ``shard`` rides
    on the result (a ``LocalConfig``) for its passes' collectives."""
    if tp == 1:
        return cfg
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if rules.get("heads") != "tp":
        raise NotImplementedError(
            f"tp={tp} does not divide n_heads={hq}: replicated q heads are "
            f"not served on a mesh")
    hq_l = hq // tp
    if rules.get("kv_heads") == "tp":
        hkv_l = hkv // tp
    else:
        group = hq // hkv
        if group % hq_l:
            raise NotImplementedError(
                f"tp={tp}: a rank's {hq_l} q heads span more than one of "
                f"the {hkv} replicated kv heads")
        hkv_l = 1
    ffn = cfg.d_ff
    if ffn % tp:
        raise ValueError(f"tp={tp} does not divide d_ff={ffn}")
    local = replace(cfg, n_heads=hq_l, n_kv_heads=hkv_l, d_ff=ffn // tp,
                    head_dim_override=cfg.head_dim)
    return LocalConfig(**{f.name: getattr(local, f.name)
                          for f in fields(DecoderConfig)}, tp=shard)


def select_kv_heads(params: Params, cfg: DecoderConfig, tp: int,
                    rank: int) -> Params:
    """Where tp replicates the kv heads (tp does not divide n_kv_heads),
    keep of ``wk``/``wv`` only the columns of the kv head tp rank
    ``rank``'s q heads group to, so each rank attends its q heads with
    their own kv head (GQA grouping: q head h reads kv head
    h // (n_heads / n_kv_heads)). Every part of a quantized leaf keeps the
    same columns."""
    dh = cfg.head_dim
    kv = (rank * (cfg.n_heads // tp)) // (cfg.n_heads // cfg.n_kv_heads)
    cols = slice(kv * dh, (kv + 1) * dh)

    def pick(w):
        if isinstance(w, dict):
            return {k: v[..., cols].contiguous() for k, v in w.items()}
        return w[..., cols].contiguous()

    layers_t = dict(params["layers"])
    for name in ("wk", "wv"):
        layers_t[name] = pick(layers_t[name])
    return {**params, "layers": layers_t}


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


def _ffn(x: torch.Tensor, layer: Params, cfg: DecoderConfig,
         impl: str = "auto") -> torch.Tensor:
    """The block's FFN: the experts of an MoE config, else SwiGLU."""
    if cfg.is_moe:
        return moe_ffn(x, layer, cfg, impl)
    return L.swiglu(x, layer, impl)


def _unembed(x: torch.Tensor, params: Params, cfg: DecoderConfig,
             impl: str = "auto") -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = (x @ params["tok_emb"].T).float()
    else:
        logits = L.qmatmul(x, params["lm_head"], impl).float()
    tp = getattr(cfg, "tp", None)
    # vocab-parallel: every rank of a tp group ends with the whole row
    return logits if tp is None else all_gather_last(logits, tp.group)


def _block(x: torch.Tensor, layer: Params, cfg: DecoderConfig,
           lengths: torch.Tensor | None, impl: str,
           attn_impl: str | None = None):
    """One transformer block; returns (x, k, v) of the block."""
    h, k, v = L.attn_prefill(L.rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                             layer, cfg, lengths=lengths, impl=impl,
                             attn_impl=attn_impl)
    x = x + _reduce(h, cfg)
    return _ffn_residual(x, layer, cfg, impl), k, v


def _ffn_residual(x: torch.Tensor, layer: Params, cfg: DecoderConfig,
                  impl: str = "auto") -> torch.Tensor:
    """x + the block's FFN of norm(x), its partial sum completed over tp
    (after the experts' combine, for MoE)."""
    return x + _reduce(_ffn(L.rms_norm(x, layer["ffn_norm"], cfg.norm_eps),
                            layer, cfg, impl), cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            lengths: torch.Tensor | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Scoring pass: [B, S] int tokens → [B, S, V] f32 logits."""
    x = _embed(params, tokens, cfg)
    for li in range(cfg.n_layers):
        x, _, _ = _block(x, layer_params(params, li), cfg, lengths, impl)
    return _unembed(x, params, cfg, impl)


def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> Params:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    device = resolve_device(device)
    return {"k": zeros(shape, dtype, device),
            "v": zeros(shape, dtype, device)}


def prefill(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
            cfg: DecoderConfig, cache: Params, impl: str = "auto",
            attn_impl: str | None = None) -> tuple[torch.Tensor, Params]:
    """Prompt pass. tokens: [B, S] right-padded; lengths: [B]. Writes kv
    for positions [0, S) into ``cache`` in place and returns
    (last-valid-position logits [B, V] f32, cache). ``attn_impl`` picks
    the attention's route alone (the JAX package's ``attn_impl``; None:
    ``impl``'s)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    for li in range(cfg.n_layers):
        x, k, v = _block(x, layer_params(params, li), cfg, lengths, impl,
                         attn_impl)
        cache["k"][li, :, :, :s] = k
        cache["v"][li, :, :, :s] = v
    # Select each row's last valid hidden state BEFORE the lm_head, so
    # only B rows (not B·S) are unembedded.
    x_last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return _unembed(x_last, params, cfg, impl), cache


def prefill_seeded(params: Params, tokens: torch.Tensor,
                   lengths: torch.Tensor, k_pref: torch.Tensor,
                   v_pref: torch.Tensor, prefix_lens: torch.Tensor,
                   cfg: DecoderConfig, cache: Params
                   ) -> tuple[torch.Tensor, Params]:
    """Suffix prompt pass against seeded prefix KV (contiguous prefix-cache
    hits). tokens: [B, S] right-padded SUFFIX tokens, row b's token i at
    absolute position ``prefix_lens[b] + i``; lengths: [B] suffix lengths
    (>= 1). k_pref/v_pref: [L, B, Hkv, P, Dh] prefix KV gathered from the
    block pool (columns at or past ``prefix_lens[b]`` are masked). Writes
    the SUFFIX kv into ``cache`` positions [0, S) in place (the engine
    writes them into the slot cache at the per-row offset) and returns
    (last-valid-position logits [B, V] f32, cache). A row with prefix 0
    attends its own causal suffix alone, so mixed hit/miss waves run as
    one pass."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h, k, v = L.attn_prefill_seeded(
            L.rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
            k_pref[li], v_pref[li], prefix_lens, lengths)
        x = _ffn_residual(x + _reduce(h, cfg), layer, cfg)
        cache["k"][li, :, :, :s] = k
        cache["v"][li, :, :, :s] = v
    x_last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return _unembed(x_last, params, cfg), cache


def decode_step_windowed(params: Params, tokens: torch.Tensor,
                         positions0: torch.Tensor, w: int,
                         cfg: DecoderConfig, cache: Params,
                         k_win: torch.Tensor, v_win: torch.Tensor,
                         kv_len: int | None = None,
                         k_done: torch.Tensor | None = None,
                         v_done: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One decode step that never writes the big cache.

    Fresh KV lives in the per-window buffers ``k_win``/``v_win``
    [L, B, Hkv, W, Dh] (the caller fills column ``w`` with this step's
    result) and reaches the cache once per dispatch (``merge_window``). A
    dispatch of several windows passes the completed ones as
    ``k_done``/``v_done`` [L, B, Hkv, Wd, Dh], a fourth attention piece,
    instead of merging them.

    tokens: [B]; positions0: [B] dispatch-start positions; ``w``: step
    index in the current window; ``kv_len`` bounds the cache prefix
    attention reads. Returns ([B, V] f32 logits, k_cols, v_cols
    [L, B, Hkv, Dh])."""
    x = _embed(params, tokens, cfg)[:, None, :]        # [B, 1, D]
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
            k_win[li], v_win[li],
            k_done_l=None if k_done is None else k_done[li],
            v_done_l=None if v_done is None else v_done[li])
        x = _ffn_residual(x + _reduce(h, cfg), layer, cfg)
        k_cols.append(k_cur)
        v_cols.append(v_cur)
    return (_unembed(x, params, cfg)[:, 0], torch.stack(k_cols),
            torch.stack(v_cols))


def decode_step_windowed_paged(params: Params, tokens: torch.Tensor,
                               positions0: torch.Tensor, w: int,
                               cfg: DecoderConfig, partial_fn,
                               k_win: torch.Tensor, v_win: torch.Tensor,
                               k_done: torch.Tensor | None = None,
                               v_done: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Paged twin of :func:`decode_step_windowed`: the committed KV is
    never an array here — ``partial_fn(li, qg, lengths, q_pos)`` scores
    the slot's pool blocks of layer ``li`` in place, and the window
    buffers (completed windows as ``k_done``/``v_done``) carry the
    dispatch's fresh KV until the caller's one pool scatter. Returns
    ([B, V] f32 logits, k_cols, v_cols [L, B, Hkv, Dh]).

    K3 takes int32 lengths and query positions: they are built here once
    a step (the engine passes int32 ``positions0``, so only the add runs),
    not in every layer."""
    x = _embed(params, tokens, cfg)[:, None, :]        # [B, 1, D]
    positions0 = positions0.to(torch.int32)
    n_done = 0 if k_done is None else k_done.shape[3]
    q_pos = positions0 + (n_done + w)
    k_cols, v_cols = [], []
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h, k_cur, v_cur = L.attn_decode_windowed_paged(
            L.rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
            positions0, w, q_pos, functools.partial(partial_fn, li),
            k_win[li], v_win[li],
            k_done_l=None if k_done is None else k_done[li],
            v_done_l=None if v_done is None else v_done[li])
        x = _ffn_residual(x + _reduce(h, cfg), layer, cfg)
        k_cols.append(k_cur)
        v_cols.append(v_cur)
    return (_unembed(x, params, cfg)[:, 0], torch.stack(k_cols),
            torch.stack(v_cols))


def prefill_seeded_paged(params: Params, tokens: torch.Tensor,
                         lengths: torch.Tensor, prefix_lens: torch.Tensor,
                         cfg: DecoderConfig, partial_fn, *,
                         all_logits: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Seeded suffix pass over the block pool — seeded admission and the
    chunked-prefill continuation (``all_logits=False``), the speculative
    verify (``all_logits=True``): right-padded suffix tokens [B, S] at
    absolute positions ``prefix_lens[b] + i`` attend their prefix, scored
    off the pool by ``partial_fn(li, q_rows, lengths, q_pos)`` (prefix
    columns at or past ``prefix_lens[b]`` are unreadable), and their own
    causal suffix below ``lengths[b]``. Returns (logits, k_new, v_new
    [L, B, Hkv, S, Dh] in the compute dtype for the pool scatter): logits
    are [B, S, V] f32 with ``all_logits``, else the last valid position's
    [B, V], selected before the lm_head. ``prefix_lens`` goes to K3 as
    int32, converted once here."""
    b, s = tokens.shape
    prefix_lens = prefix_lens.to(torch.int32)
    x = _embed(params, tokens, cfg)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    k_new = torch.empty(shape, dtype=x.dtype, device=x.device)
    v_new = torch.empty(shape, dtype=x.dtype, device=x.device)
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h, k_new[li], v_new[li] = L.attn_prefill_seeded_paged(
            L.rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
            functools.partial(partial_fn, li), prefix_lens, lengths)
        x = _ffn_residual(x + _reduce(h, cfg), layer, cfg)
    if all_logits:
        return _unembed(x, params, cfg), k_new, v_new
    x_last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return _unembed(x_last, params, cfg), k_new, v_new


def verify_seeded(params: Params, tokens: torch.Tensor,
                  lengths: torch.Tensor, prefix_lens: torch.Tensor,
                  cfg: DecoderConfig, cache: Params,
                  kv_len: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token seeded pass over DECODE SLOTS of the contiguous cache —
    the speculative verify and the chunked-prefill continuation.

    Row b's S tokens (the committed next token and its drafted
    continuation, or the next prompt chunk) sit at absolute positions
    ``prefix_lens[b] + i`` and attend (slot cache prefix ++ fresh causal
    suffix) through ``attn_prefill_seeded``: one weight pass scores all S
    positions of every slot. The cache is read in place, sliced to the
    static ``kv_len``; positions at or past ``prefix_lens[b]`` are masked,
    so KV left from a previous dispatch's rejected drafts is dead.

    tokens: [B, S] right-padded; lengths: [B] valid tokens per row
    (>= 1); prefix_lens: [B] committed cache prefix per slot (parked
    slots sit at ``max_len``; their output is dropped). Returns (logits
    [B, S, V] f32, k_new, v_new [L, B, Hkv, S, Dh] in the compute dtype,
    ``merge_window``'s layout, for the one write at the per-row offset)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    k_pref, v_pref = cache["k"], cache["v"]
    if kv_len is not None and kv_len < k_pref.shape[3]:
        k_pref = k_pref[:, :, :, :kv_len]
        v_pref = v_pref[:, :, :, :kv_len]
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    k_new = torch.empty(shape, dtype=x.dtype, device=x.device)
    v_new = torch.empty(shape, dtype=x.dtype, device=x.device)
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        h, k_new[li], v_new[li] = L.attn_prefill_seeded(
            L.rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
            k_pref[li], v_pref[li], prefix_lens, lengths)
        x = _ffn_residual(x + _reduce(h, cfg), layer, cfg)
    return _unembed(x, params, cfg), k_new, v_new


def decode_step_piggyback(params: Params, tokens: torch.Tensor,
                          positions0: torch.Tensor, w: int,
                          cfg: DecoderConfig, cache: Params,
                          k_win: torch.Tensor, v_win: torch.Tensor,
                          pre_tok: torch.Tensor, pre_rope_base: torch.Tensor,
                          pre_kv_begin: torch.Tensor,
                          pre_kv_len: torch.Tensor,
                          pre_sel_rel: torch.Tensor,
                          pre_kbuf: torch.Tensor, pre_vbuf: torch.Tensor,
                          kv_len: int | None = None):
    """One decode step that also advances P prefill lanes by a C-token
    chunk (piggyback prefill with lane packing).

    Every projection, ``wo`` and the FFN take the B decode rows and the
    P·C prompt-chunk rows as ONE row-concatenated matmul (M = B + P·C), so
    the chunks' work rides the weight stream decode already pays for. The
    engine packs whole prompts into the W x P chunk grid on the host
    (``GenerationEngine._pack_prefill``); lane p's dispatch buffer holds
    consecutive rows' chunks back to back. This step's metadata:

    * pre_tok [P, C]      — the chunk's token ids a lane;
    * pre_rope_base [P]   — chunk-start position within its row (RoPE);
    * pre_kv_begin [P]    — buffer column where the row's kv starts
      (earlier columns belong to other rows and are masked);
    * pre_kv_len [P]      — valid buffer columns through this step (masks
      a final partial chunk; idle lanes carry 0);
    * pre_sel_rel [P]     — the in-chunk index of the row's last prompt
      token when this chunk completes the row; ``h_step`` is the hidden
      state there, from which the engine samples its first token;
    * pre_kbuf/pre_vbuf [L, P, Hkv, W·C, Dh] — the dispatch's chunk
      buffers. This step writes its chunk's KV into columns
      [w·C, (w+1)·C) of them in place; the engine writes them into the
      cache once a dispatch (``merge_prefill``).

    The chunk attention is ONE K1 call a layer over the lane buffer,
    causal, with query offset w·C and the begin/length bounds above, so
    a row never reads a packed neighbour's kv. The decode rows attend
    (cache prefix ++ window ++ self) as in ``decode_step_windowed``.

    Under tp (a ``local_config``) the heads are the rank's, one
    all-reduce completes ``wo``'s and one the FFN's partial sums over the
    M rows, and the embedding and the decode rows' lm_head are
    vocab-parallel; ``h_step`` is whole, and the engine unembeds it.

    Returns (logits [B, V] f32, k_cols, v_cols [L, B, Hkv, Dh],
    pre_k, pre_v [L, P, Hkv, C, Dh], h_step [P, D]). Dense FFN only: the
    engine never piggybacks an MoE config."""
    if cfg.is_moe:
        raise ValueError("piggyback prefill: dense FFN only")
    b = tokens.shape[0]
    p, c = pre_tok.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dev = tokens.device
    # the decode rows and the chunk rows in one lookup (one all-reduce)
    x = _embed(params, torch.cat([tokens.long(), pre_tok.reshape(-1)
                                  .long()]), cfg)            # [M, D]
    d_model = x.shape[-1]
    pos_dec = (positions0 + w)[:, None]                      # [B, 1]
    pos_pre = pre_rope_base.long()[:, None] + torch.arange(
        c, device=dev)[None, :]                              # [P, C]
    k_pref, v_pref = cache["k"], cache["v"]
    if kv_len is not None and kv_len < k_pref.shape[3]:
        k_pref = k_pref[:, :, :, :kv_len]
        v_pref = v_pref[:, :, :, :kv_len]
    inv_freq = L.rope_frequencies(dh, cfg.rope_theta, device=dev)
    q_offsets = torch.full((p,), w * c, dtype=torch.int32, device=dev)
    k_cols, v_cols, pre_k, pre_v = [], [], [], []
    for li in range(cfg.n_layers):
        layer = layer_params(params, li)
        xa = L.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        # ONE projection matmul over the decode and the prefill rows
        if "wqkv" in layer:
            nq, nkv = hq * dh, hkv * dh
            qkv = L.qmatmul(xa, layer["wqkv"])
            q_all, k_all, v_all = (qkv[..., :nq], qkv[..., nq:nq + nkv],
                                   qkv[..., nq + nkv:])
        else:
            q_all = L.qmatmul(xa, layer["wq"])
            k_all = L.qmatmul(xa, layer["wk"])
            v_all = L.qmatmul(xa, layer["wv"])

        def split_heads(z, n_heads):
            zd = z[:b].reshape(b, 1, n_heads, dh).transpose(1, 2)
            zp = z[b:].reshape(p, c, n_heads, dh).transpose(1, 2)
            return zd, zp

        qd, qp = split_heads(q_all, hq)
        kd, kp = split_heads(k_all, hkv)
        vd, vp = split_heads(v_all, hkv)
        qd = L.apply_rope(qd, pos_dec, inv_freq)
        kd = L.apply_rope(kd, pos_dec, inv_freq)
        qp = L.apply_rope(qp, pos_pre, inv_freq)
        kp = L.apply_rope(kp, pos_pre, inv_freq)
        o_dec = decode_attention_prefix_window(
            qd[:, :, 0], k_pref[li], v_pref[li], k_win[li], v_win[li],
            kd[:, :, 0], vd[:, :, 0], prefix_lengths=positions0, w=w,
            window=cfg.sliding_window)                       # [B, Hq, Dh]
        # the chunk's kv joins its lane buffer, then one K1 call over it
        kbuf, vbuf = pre_kbuf[li], pre_vbuf[li]
        kbuf[:, :, w * c:(w + 1) * c] = kp
        vbuf[:, :, w * c:(w + 1) * c] = vp
        o_pre = flash_attention(
            qp.contiguous(), kbuf.to(qp.dtype), vbuf.to(qp.dtype),
            causal=True, kv_lengths=pre_kv_len, q_offsets=q_offsets,
            kv_begins=pre_kv_begin)                          # [P, Hq, C, Dh]
        o = torch.cat([o_dec.reshape(b, hq * dh),
                       o_pre.transpose(1, 2).reshape(p * c, hq * dh)])
        x = x + _reduce(L.qmatmul(o, layer["wo"]), cfg)      # one wo matmul
        x = x + _reduce(L.swiglu(L.rms_norm(x, layer["ffn_norm"],
                                            cfg.norm_eps), layer),
                        cfg)                                 # one FFN pass
        k_cols.append(kd[:, :, 0])
        v_cols.append(vd[:, :, 0])
        pre_k.append(kp)
        pre_v.append(vp)
    logits = _unembed(x[:b], params, cfg)
    x_pre_out = x[b:].reshape(p, c, d_model)
    h_step = x_pre_out[torch.arange(p, device=dev),
                       pre_sel_rel.long().clamp(0, c - 1)]    # [P, D]
    return (logits, torch.stack(k_cols), torch.stack(v_cols),
            torch.stack(pre_k), torch.stack(pre_v), h_step)


def merge_prefill(cache: Params, k_buf: torch.Tensor, v_buf: torch.Tensor,
                  lanes, cols, slots, positions) -> Params:
    """Write a piggyback dispatch's chunk buffers into the cache, in place.

    k_buf/v_buf: [L, P, Hkv, BUF, Dh]; the host-built maps (1-D, one entry
    a prompt token) say where each live buffer column goes: column
    ``cols[i]`` of lane ``lanes[i]`` lands at position ``positions[i]`` of
    slot ``slots[i]``. The maps hold live columns only — padding and idle
    columns are left out on the host (the JAX package's ``mode="drop"``),
    so nothing writes into a live slot's timeline and nothing indexes out
    of range. An fp8 cache moves as bytes."""
    if len(lanes) == 0:
        return cache
    dev = cache["k"].device

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long).to(dev)

    ln, cl, sl, ps = idx(lanes), idx(cols), idx(slots), idx(positions)
    for name, buf in (("k", k_buf), ("v", v_buf)):
        # advanced indices on axes 1 and 3: [N, L, Hkv, Dh] both sides
        storage_view(cache[name])[:, sl, :, ps, :] = storage_view(
            buf[:, ln, :, cl, :].to(cache[name].dtype))
    return cache


def merge_window(cache: Params, k_win: torch.Tensor, v_win: torch.Tensor,
                 positions0: torch.Tensor, steps: int) -> Params:
    """Scatter a dispatch's window KV into the big cache, once, in place.

    k_win/v_win: [L, B, Hkv, W, Dh]; slot b's window columns land at
    cache positions ``positions0[b] + [0, steps)``. Columns at or past
    the cache extent are dropped (parked slots sit there). The write has
    a static shape — no host sync, so a CUDA graph can hold it: a dropped
    column is redirected to the slot's column ``min(positions0[b],
    extent) - 1``, whose own value is written back. No kept column of the
    slot lands there (they start at ``positions0[b]``), and every slot
    writes only its own row, so the cache ends as if the dropped columns
    were never written. The window buffers hold the cache's dtype; an
    fp8 cache moves as bytes (``storage_view``)."""
    b, w = k_win.shape[1], k_win.shape[3]
    steps = min(steps, w)
    s_max = cache["k"].shape[3]
    dev = cache["k"].device
    p0 = positions0.to(dev).long()
    pidx = p0[:, None] + torch.arange(steps, device=dev)[None, :]
    keep = pidx < s_max                                      # [B, steps]
    back = (p0.clamp(max=s_max) - 1).clamp(min=0)[:, None]
    pidx = torch.where(keep, pidx, back)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, steps)
    keep = keep[:, :, None, None, None]
    for name, win in (("k", k_win), ("v", v_win)):
        c = storage_view(cache[name])
        # advanced indices on axes 1 and 3 put the [B, steps] index axes
        # first: [B, steps, L, Hkv, Dh] on both sides
        upd = storage_view(win[:, :, :, :steps].permute(1, 3, 0, 2, 4)
                           .to(cache[name].dtype))
        c[:, bidx, :, pidx, :] = torch.where(keep, upd,
                                             c[:, bidx, :, pidx, :])
    return cache
