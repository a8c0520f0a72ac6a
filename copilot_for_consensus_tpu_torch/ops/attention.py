"""Attention front end and the plain attention functions.

Port of the JAX package's ``ops/attention.py`` (the parts the contiguous
serving path runs). Shapes, GQA throughout:
    q: [B, Hq, S, D]    k, v: [B, Hkv, S, D]    Hq % Hkv == 0

``attention`` is the prefill dispatch: ``impl="auto"`` goes through the K1
wrapper (the CUDA kernel on the card, its plain version on the CPU),
``impl="plain"`` selects K1's plain version on any device. Decode
attention over the contiguous cache is plain PyTorch, as it is plain XLA
in the JAX package.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

IMPLS = ("auto", "plain")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  kv_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Reference attention with an f32 softmax — the port of
    ``attention_xla``: K1's plain version, which holds the one mask rule."""
    return attention(q, k, v, causal=causal, window=window,
                     kv_lengths=kv_lengths, q_offset=q_offset, impl="plain")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_lengths: torch.Tensor | None = None, q_offset: int = 0,
              impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention (prefill). ``impl``: "auto" → the K1
    wrapper; "plain" → K1's plain version (for holding the kernel
    against it on the card)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    offsets = None
    if q_offset:
        offsets = torch.full((q.shape[0],), q_offset, dtype=torch.int32,
                             device=q.device)
    fn = flash_attention if impl == "auto" else flash_attention_ref
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, kv_lengths=kv_lengths, q_offsets=offsets)


def _grouped_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Unscaled-then-scaled GQA scores [B, Hkv, G, S] of grouped queries
    against one KV piece [B, Hkv, S, D], f32."""
    d = qg.shape[-1]
    return torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float()) \
        * (d ** -0.5)


def _piece_mask(pos_abs: torch.Tensor, valid_below: torch.Tensor,
                q_pos: torch.Tensor, window: int) -> torch.Tensor:
    """A column at absolute position ``pos_abs`` is attendable iff it is
    strictly below the piece's valid bound and — under a sliding window —
    within ``window`` positions of the query's own position ``q_pos``."""
    mask = pos_abs < valid_below
    if window > 0:
        mask = mask & (pos_abs > q_pos - window)
    return mask


def _joint_probs(pieces_logits: list[torch.Tensor]) -> list[torch.Tensor]:
    """One softmax over the concatenated (already masked) score pieces,
    split back per piece. Fully-masked rows (parked slots) give NaN
    probabilities, which are zeroed."""
    logits = torch.cat(pieces_logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)
    if len(pieces_logits) == 1:
        return [probs]
    return list(torch.split(probs, [p.shape[-1] for p in pieces_logits],
                            dim=-1))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0,
                     kv_len: int | None = None) -> torch.Tensor:
    """Single-token decode attention over a slot KV cache.

    q: [B, Hq, D]; caches: [B, Hkv, S_max, D]; lengths: [B] valid cache
    positions per slot (the new token's kv already written). ``kv_len``
    restricts the read to the cache prefix [0, kv_len)."""
    if kv_len is not None and kv_len < k_cache.shape[2]:
        k_cache = k_cache[:, :, :kv_len]
        v_cache = v_cache[:, :, :kv_len]
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    logits = _grouped_scores(qg, k_cache)
    pos = torch.arange(s_max, device=q.device)[None, None, None, :]
    lens = lengths.to(q.device)[:, None, None, None]
    mask = _piece_mask(pos, lens, lens - 1, window)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = _joint_probs([logits])[0]
    out = torch.einsum("bhgs,bhsd->bhgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, d)


def decode_attention_prefix_window(
    q: torch.Tensor,
    k_pref: torch.Tensor,
    v_pref: torch.Tensor,
    k_win: torch.Tensor,
    v_win: torch.Tensor,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    prefix_lengths: torch.Tensor,
    w: int,
    window: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Decode attention over three KV pieces with one joint softmax: the
    read-only prefix cache (``k_pref`` [B, Hkv, S_max, D], valid below
    ``prefix_lengths``), the current window's fresh KV (``k_win``
    [B, Hkv, W, D], valid columns [0, w)), and the current token's own KV
    (``k_cur`` [B, Hkv, D]). Numerically the attention over one
    contiguous cache holding the pieces back to back.

    q: [B, Hq, D]; prefix_lengths: [B] — where this dispatch started;
    ``w``: the step index inside the window; ``window``: sliding-window
    size (0 = full)."""
    if kv_len is not None and kv_len < k_pref.shape[2]:
        k_pref = k_pref[:, :, :kv_len]
        v_pref = v_pref[:, :, :kv_len]
    dt = q.dtype
    k_pref, v_pref = k_pref.to(dt), v_pref.to(dt)
    k_win, v_win = k_win.to(dt), v_win.to(dt)
    k_cur, v_cur = k_cur.to(dt), v_cur.to(dt)
    b, hq, d = q.shape
    hkv, s_max = k_pref.shape[1], k_pref.shape[2]
    n_win = k_win.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)

    lp = _grouped_scores(qg, k_pref)
    lw = _grouped_scores(qg, k_win)
    lc = torch.einsum("bhgd,bhd->bhg", qg.float(),
                      k_cur.float())[..., None] * (d ** -0.5)

    # The dispatch's own columns start at prefix_lengths: window column i
    # at +i; the token itself sits at +w.
    pl = prefix_lengths.to(q.device)[:, None, None, None]
    cur_pos = pl + w
    pos_p = torch.arange(s_max, device=q.device)[None, None, None, :]
    mask_p = _piece_mask(pos_p, pl, cur_pos, window)
    pos_w = pl + torch.arange(n_win, device=q.device)[None, None, None, :]
    mask_w = _piece_mask(pos_w, cur_pos, cur_pos, window)
    lp = lp.masked_fill(~mask_p, float("-inf"))
    lw = lw.masked_fill(~mask_w, float("-inf"))

    pp, pw, pc = _joint_probs([lp, lw, lc])
    out = torch.einsum("bhgs,bhsd->bhgd", pp.to(dt), v_pref)
    out = out + torch.einsum("bhgw,bhwd->bhgd", pw.to(dt), v_win)
    out = out + pc.to(dt) * v_cur[:, :, None, :]
    return out.reshape(b, hq, d)
