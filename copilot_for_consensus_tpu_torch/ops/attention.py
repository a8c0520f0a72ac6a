"""Attention front end and the plain attention functions.

Port of the JAX package's ``ops/attention.py`` (the parts the contiguous
and paged serving paths run). Shapes, GQA throughout:
    q: [B, Hq, S, D]    k, v: [B, Hkv, S, D]    Hq % Hkv == 0

``attention`` is the prefill dispatch: ``impl="auto"`` goes through the K1
wrapper (the CUDA kernel on the card, its plain version on the CPU),
``impl="plain"`` selects K1's plain version on any device. Decode
attention over the contiguous cache is plain PyTorch, as it is plain XLA
in the JAX package. So are the flash-partial functions of the paged route
(``combine_partials``, ``decode_window_partial``,
``causal_suffix_partial``): K3 scores the pool piece, these score the
dispatch-local pieces and fold everything into one joint softmax, with
every mask through ``_piece_mask``.
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
    k_done: torch.Tensor | None = None,
    v_done: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention over up to four KV pieces with one joint softmax:
    the read-only prefix cache (``k_pref`` [B, Hkv, S_max, D], valid below
    ``prefix_lengths``), the completed windows of this dispatch
    (``k_done`` [B, Hkv, Wd, D], every column valid: they are kept out of
    the cache until the dispatch's one write), the current window's fresh
    KV (``k_win`` [B, Hkv, W, D], valid columns [0, w)), and the current
    token's own KV (``k_cur`` [B, Hkv, D]). Numerically the attention over
    one contiguous cache holding the pieces back to back.

    q: [B, Hq, D]; prefix_lengths: [B] — where this dispatch started (done
    columns sit at +[0, Wd), window column i at +Wd+i, the token at
    +Wd+w); ``w``: the step index inside the current window; ``window``:
    sliding-window size (0 = full), which masks the done piece too."""
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
    n_done = 0 if k_done is None else k_done.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)

    lp = _grouped_scores(qg, k_pref)
    lw = _grouped_scores(qg, k_win)
    lc = torch.einsum("bhgd,bhd->bhg", qg.float(),
                      k_cur.float())[..., None] * (d ** -0.5)

    # The dispatch's own columns start at prefix_lengths: done columns at
    # +[0, n_done), window column i at +n_done+i; the token itself sits at
    # +n_done+w. Every piece runs the same mask rule against that timeline.
    pl = prefix_lengths.to(q.device)[:, None, None, None]
    cur_pos = pl + n_done + w
    pos_p = torch.arange(s_max, device=q.device)[None, None, None, :]
    mask_p = _piece_mask(pos_p, pl, cur_pos, window)
    pos_w = pl + n_done + torch.arange(n_win, device=q.device)[
        None, None, None, :]
    mask_w = _piece_mask(pos_w, cur_pos, cur_pos, window)
    lp = lp.masked_fill(~mask_p, float("-inf"))
    lw = lw.masked_fill(~mask_w, float("-inf"))
    pieces = [lp]
    if n_done:
        ld = _grouped_scores(qg, k_done.to(dt))
        pos_dn = pl + torch.arange(n_done, device=q.device)[
            None, None, None, :]
        # done columns are all committed (below cur_pos): only the
        # sliding window can mask them
        pieces.append(ld.masked_fill(
            ~_piece_mask(pos_dn, cur_pos, cur_pos, window), float("-inf")))
    pieces += [lw, lc]

    parts = _joint_probs(pieces)
    out = torch.einsum("bhgs,bhsd->bhgd", parts[0].to(dt), v_pref)
    if n_done:
        out = out + torch.einsum("bhgw,bhwd->bhgd", parts[1].to(dt),
                                 v_done.to(dt))
    out = out + torch.einsum("bhgw,bhwd->bhgd", parts[-2].to(dt), v_win)
    out = out + parts[-1].to(dt) * v_cur[:, :, None, :]
    return out.reshape(b, hq, d)


# ---------------------------------------------------------------------------
# flash partials: the paged route's joint softmax over separate KV pieces
# ---------------------------------------------------------------------------


def _safe(m: torch.Tensor) -> torch.Tensor:
    """``m`` with -inf (a fully masked row) pinned to 0, so that
    ``exp(s - m)`` never forms ``-inf - -inf``."""
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def combine_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """Fold flash-style (acc, m, l) partials of independent KV pieces into
    the jointly softmaxed attention output — what lets K3 score the pool
    piece in place while the dispatch-local pieces stay plain PyTorch.

    Each part: acc [..., R, D] = Σ exp(s - m)·v over its piece, m
    [..., R, 1] its max (-inf when fully masked), l [..., R, 1] =
    Σ exp(s - m). Rows masked in EVERY piece emit exact zeros — the value
    ``_joint_probs``'s NaN guard produces."""
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    m_safe = _safe(m_tot)
    l_tot = acc_tot = 0.0
    for acc, m, l in parts:
        scale = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l_tot = l_tot + l * scale
        acc_tot = acc_tot + acc * scale
    ok = l_tot > 0
    out = acc_tot / torch.where(ok, l_tot, torch.ones_like(l_tot))
    return torch.where(ok, out, torch.zeros_like(out)).to(dtype)


def _masked_partial(logits: torch.Tensor, v_pieces: list[torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc, m, l) of already-masked score rows [..., R, T] against their
    stacked values [..., T, D], f32 throughout. ``logits`` is consumed:
    it becomes the probabilities in place (the seeded wave's score
    tensor is the largest transient of admission)."""
    v_all = torch.cat([v.float() for v in v_pieces], dim=-2) \
        if len(v_pieces) > 1 else v_pieces[0].float()
    m = logits.amax(dim=-1, keepdim=True)
    p = logits.sub_(_safe(m)).exp_()                 # exp(-inf) = 0 pads
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v_all)
    return acc, m, l


def decode_window_partial(
    qg: torch.Tensor,
    k_win: torch.Tensor,
    v_win: torch.Tensor,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    prefix_lengths: torch.Tensor,
    w: int,
    window: int = 0,
    k_done: torch.Tensor | None = None,
    v_done: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partial over the DISPATCH-LOCAL pieces of
    ``decode_attention_prefix_window`` — completed windows, current
    window, self — everything except the pool piece, which K3 scores in
    place. Masks are ``_piece_mask`` against the same dispatch timeline,
    so folding this with the pool partial reproduces the joint softmax.

    qg: [B, Hkv, G, D] grouped queries; k_win/v_win: [B, Hkv, W, D];
    k_cur/v_cur: [B, Hkv, D]; k_done/v_done: [B, Hkv, Wd, D]. Returns f32
    (acc [B, Hkv, G, D], m/l [B, Hkv, G, 1])."""
    dt = qg.dtype
    dev = qg.device
    n_win = k_win.shape[2]
    n_done = 0 if k_done is None else k_done.shape[2]
    d = qg.shape[-1]
    pl = prefix_lengths.to(dev)[:, None, None, None]
    cur_pos = pl + n_done + w

    lw = _grouped_scores(qg, k_win.to(dt))
    lc = torch.einsum("bhgd,bhd->bhg", qg.float(),
                      k_cur.to(dt).float())[..., None] * (d ** -0.5)
    pos_w = pl + n_done + torch.arange(n_win, device=dev)[None, None, None]
    lw = lw.masked_fill(~_piece_mask(pos_w, cur_pos, cur_pos, window),
                        float("-inf"))
    pieces_l, pieces_v = [], []
    if n_done:
        ld = _grouped_scores(qg, k_done.to(dt))
        pos_dn = pl + torch.arange(n_done, device=dev)[None, None, None]
        pieces_l.append(ld.masked_fill(
            ~_piece_mask(pos_dn, cur_pos, cur_pos, window), float("-inf")))
        pieces_v.append(v_done.to(dt))
    pieces_l += [lw, lc]
    pieces_v += [v_win.to(dt), v_cur.to(dt)[:, :, None, :]]
    return _masked_partial(torch.cat(pieces_l, dim=-1), pieces_v)


def causal_suffix_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partial over the fresh causal-suffix piece of a seeded
    prefill (``jk <= iq`` and below the row's valid suffix length), with
    the (g, s) query rows flattened row-major into R = G·S — the row
    layout K3 scores the pool prefix in, so the two partials zip straight
    into ``combine_partials``.

    q: [B, Hq, S, D]; k/v: [B, Hkv, S, D]. Returns f32
    (acc [B, Hkv, G·S, D], m/l [B, Hkv, G·S, 1])."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    logits.mul_(d ** -0.5)
    iq = torch.arange(s, device=q.device)
    mask = (iq[None, :] <= iq[:, None])[None, None, None]
    if kv_lengths is not None:
        mask = mask & (iq[None, None, None, None, :]
                       < kv_lengths.to(q.device)[:, None, None, None, None])
    logits.masked_fill_(~mask, float("-inf"))
    return _masked_partial(logits.reshape(b, hkv, g * s, s), [v])


# ---------------------------------------------------------------------------
# seeded suffix attention: the contiguous verify and chunk passes
# ---------------------------------------------------------------------------


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 output over the leading batch dims. On the
    card, bf16 or f16 operands stay in their dtype and accumulate into
    f32 (the JAX reference's ``preferred_element_type``): nothing is cast
    up before the product. Elsewhere, and for f32 operands, the product
    runs in f32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-2], *out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def prefill_attention_seeded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_pref: torch.Tensor,
    v_pref: torch.Tensor,
    prefix_lens: torch.Tensor,
    kv_lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Suffix-prefill attention over (seeded prefix KV ++ fresh suffix KV),
    one joint softmax — the speculative verify pass and the chunked
    prefill continuation of the contiguous engine (``decoder
    .verify_seeded``), whose prefix is the slot's own cache.

    Row b's queries sit at absolute positions ``prefix_lens[b] + i``.
    Prefix column j is attended iff ``j < prefix_lens[b]`` (strict: cache
    columns at or past a slot's committed length — KV of a previous
    dispatch's rejected drafts — are unreadable, and the next write
    overwrites them); the suffix piece is causal below ``kv_lengths[b]``.
    Fully masked rows give zeros. Plain PyTorch, as the JAX package's is
    plain XLA: no Pallas kernel computes it.

    q/k/v: [B, Hq|Hkv, S, D] fresh suffix projections; k_pref/v_pref:
    [B, Hkv, P, D] in any KV dtype (an fp8 cache included), cast to q's;
    prefix_lens: [B]; kv_lengths: [B] valid suffix length per row. GQA
    runs grouped — the prefix is never expanded to Hq heads — with scores
    in f32 (``_matmul_f32``) and the output in q's dtype."""
    b, hq, s, d = q.shape
    hkv, p = k_pref.shape[1], k_pref.shape[2]
    g = hq // hkv
    dt = q.dtype
    dev = q.device
    k_pref, v_pref = k_pref.to(dt), v_pref.to(dt)
    qg = q.reshape(b, hkv, g * s, d)                 # rows (g, s)
    lp = _matmul_f32(qg, k_pref.transpose(-1, -2)) * (d ** -0.5)
    ls = _matmul_f32(qg, k.transpose(-1, -2)) * (d ** -0.5)
    jpos = torch.arange(p, device=dev)[None, None, None, :]
    lp = lp.masked_fill(~(jpos < prefix_lens.to(dev)[:, None, None, None]),
                        float("-inf"))
    iq = torch.arange(s, device=dev).repeat(g)[:, None]     # row → i
    jk = torch.arange(s, device=dev)[None, :]
    mask_s = (jk <= iq)[None, None]
    if kv_lengths is not None:
        mask_s = mask_s & (jk[None, None]
                           < kv_lengths.to(dev)[:, None, None, None])
    ls = ls.masked_fill(~mask_s, float("-inf"))
    pp, ps = _joint_probs([lp, ls])
    out = _matmul_f32(pp.to(dt), v_pref) + _matmul_f32(ps.to(dt), v)
    return out.to(dt).reshape(b, hq, s, d)
