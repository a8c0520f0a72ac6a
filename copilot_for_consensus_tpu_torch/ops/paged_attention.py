"""K3: paged flash-partial attention — wrapper of ``csrc/paged_attention.cu``
and its plain PyTorch version.

The paged engine keeps KV in one block pool ``[L, NBtot, Hkv, blk, D]``
(``engine/kv_pool.py``) addressed through per-slot block tables
``[B, NB]`` int32: position ``p`` of slot ``b`` lives at pool block
``tables[b, p // blk]``, offset ``p % blk``, layer ``li``.

Replaces the JAX package's Pallas kernel ``ops/paged_attention.py``
``paged_attention_partial_pallas`` (body ``_paged_partial_kernel``) with
the same contract: the unnormalised flash partials of R query rows per kv
head (R = group for decode, group·S for a seeded suffix pass, rows (g, s)
flattened row-major) against one layer of the stacked pool, read in
place through the table. Positions ``p < lengths[b]`` are attended and,
when ``window > 0``, only those with ``p > q_pos[b] - window``. Scores
are ``(q·k)·D**-0.5`` in f32, K and V converted to f32 on load (fp8
e4m3 pools included). Outputs are f32: ``acc = Σ exp(s - m)·v``, the
max ``m`` and ``l = Σ exp(s - m)``; a row masked everywhere gives
``m = -inf``, ``l = 0``, ``acc = 0``. ``ops.attention.combine_partials``
folds them with the dispatch-local pieces into one joint softmax.

``paged_attention_partial`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors — on no other condition. The kernel has
three bodies, chosen by :func:`paged_body` from dtypes and shape alone:
for bf16 q_rows and a bf16 pool at D 64/128 (the main path), the split-KV
body of ``csrc/paged_decode.cuh`` for decode's few rows and the wgmma body
of ``csrc/paged_wgmma.cuh`` for a seeded pass's many; the CUDA-core body
of ``csrc/paged_attention.cu`` for the rest (f32 or fp8 pools, f32 q_rows,
D 32). :func:`decode_splits` and :func:`paged_attention_partial_split_ref`
mirror the decode body's plan and its fixed-order merge in plain PyTorch.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops import _build
from copilot_for_consensus_tpu_torch.ops.attention import (
    _masked_partial,
    _piece_mask,
)

HEAD_DIMS = (32, 64, 128)
_Q_DTYPES = (torch.float32, torch.bfloat16)
#: pool dtype → the kernel's ``kv_kind`` argument
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
#: K3's bodies, the keys of ``paged_attention_partial.launches_by_body``
K3_BODIES = ("decode", "seeded", "simt")
#: head dims of the decode and seeded bodies
BODY_HEAD_DIMS = (64, 128)
#: rows a kv head up to which the split-KV decode body runs (the grouped
#: queries of one token: tensor-core tiles of 64 rows would not pay)
DECODE_MAX_R = 16
#: positions a split of the decode body spans at most: whole pool blocks
DECODE_SPLIT_POSITIONS = 256
#: positions of the seeded body's K/V tile; its pool boxes tile it exactly
SEEDED_TILE = 128


def paged_gather_layer(pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
                       tables: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The contiguous per-slot view one layer's block table describes:
    ``[NBtot, Hkv, blk, D]`` pool + ``[B, NB]`` table →
    ``[B, Hkv, NB*blk, D]``. Pad ids (>= NBtot) clamp to the last block;
    their columns sit where the caller's length mask excludes them."""
    b, nb = tables.shape
    hkv, blk, d = pool_k_l.shape[1:]
    ids = tables.long().clamp(0, pool_k_l.shape[0] - 1)
    k = pool_k_l[ids].transpose(1, 2).reshape(b, hkv, nb * blk, d)
    v = pool_v_l[ids].transpose(1, 2).reshape(b, hkv, nb * blk, d)
    return k, v


def paged_gather_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    tables: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked variant of :func:`paged_gather_layer`:
    ``[L, NBtot, Hkv, blk, D]`` pool + ``[B, NB]`` table →
    ``[L, B, Hkv, NB*blk, D]``, the slot-cache slice the contiguous
    engine's decoder reads."""
    n_l = pool_k.shape[0]
    b, nb = tables.shape
    hkv, blk, d = pool_k.shape[2:]
    ids = tables.long().clamp(0, pool_k.shape[1] - 1)
    k = pool_k[:, ids].transpose(2, 3).reshape(n_l, b, hkv, nb * blk, d)
    v = pool_v[:, ids].transpose(2, 3).reshape(n_l, b, hkv, nb * blk, d)
    return k, v


def _row_vec(x, b: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    if x.shape != (b,):
        raise ValueError(f"per-row vector must be [{b}], got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def _masked_scores(q_rows, pool_k, pool_v, li, tables, lengths, q_pos,
                   window):
    """The layer's view through the table and the f32 scores of q_rows
    against it, ``(q·k)·D**-0.5`` [B, Hkv, R, T]; returns (scores, v,
    positions [1, 1, 1, T], the attended mask)."""
    b, hkv, r, d = q_rows.shape
    lens = _row_vec(lengths, b, q_rows.device)
    qp = _row_vec(q_pos, b, q_rows.device)
    k, v = paged_gather_layer(pool_k[li], pool_v[li], tables)
    s = torch.matmul(q_rows.float(), k.float().transpose(-1, -2)) \
        * (d ** -0.5)
    pos = torch.arange(k.shape[2], device=q_rows.device)[None, None, None]
    mask = _piece_mask(pos, lens[:, None, None, None],
                       qp[:, None, None, None], window)
    return s, v, pos, mask


def paged_attention_partial_ref(
    q_rows: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    li: int, tables: torch.Tensor, lengths, q_pos, *, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 on any device: gather the layer's view through
    the table, then one f32 masked partial over it."""
    s, v, _, mask = _masked_scores(q_rows, pool_k, pool_v, li, tables,
                                   lengths, q_pos, window)
    s.masked_fill_(~mask, float("-inf"))
    return _masked_partial(s, [v])


def paged_body(r: int, q_dtype: torch.dtype, pool_dtype: torch.dtype,
               d: int, blk: int) -> str:
    """The body of K3 that a CUDA call runs, from dtypes and shape alone:
    for bf16 q_rows and a bf16 pool at D 64/128, ``"decode"`` (split-KV,
    CUDA cores) up to ``DECODE_MAX_R`` rows a kv head and ``"seeded"``
    (wgmma) above it where the pool block is whole 8-row swizzle atoms and
    tiles ``SEEDED_TILE`` positions exactly; ``"simt"`` (the CUDA-core
    body) for everything else. The paged engine's decode (R 4) and seeded
    waves (R = 4 x a bucket of at least 64) at block 64 are ``"decode"``
    and ``"seeded"``."""
    if (q_dtype != torch.bfloat16 or pool_dtype != torch.bfloat16
            or d not in BODY_HEAD_DIMS):
        return "simt"
    if r <= DECODE_MAX_R:
        return "decode"
    if blk % 8 == 0 and (SEEDED_TILE % blk == 0 or blk % SEEDED_TILE == 0):
        return "seeded"
    return "simt"


def decode_split_len(blk: int) -> int:
    """Positions a split of the decode body spans: the whole pool blocks
    that fit ``DECODE_SPLIT_POSITIONS`` (one at least)."""
    return max(1, DECODE_SPLIT_POSITIONS // blk) * blk


def decode_splits(lengths, q_pos, window: int, nb: int, blk: int
                  ) -> list[list[tuple[int, int, int]]]:
    """The decode body's plan, in plain Python: for each slot, its live
    splits ``(split, first, end)`` in the order the merge takes them. Split
    ``s`` spans positions ``[s·L, (s+1)·L)`` of the table's reach ``nb·blk``
    (``L = decode_split_len(blk)``); it is live where that meets the
    slot's attended positions ``[lo, hi)``, ``hi = min(length, nb·blk)``
    and, under a window, ``lo = q_pos - window + 1``."""
    split_len = decode_split_len(blk)
    ns = -(-nb * blk // split_len)
    plan = []
    for b, n in enumerate(lengths):
        hi = min(int(n), nb * blk)
        lo = max(0, int(q_pos[b]) - window + 1) if window > 0 else 0
        plan.append([(s, max(s * split_len, lo), min((s + 1) * split_len, hi))
                     for s in range(ns)
                     if max(s * split_len, lo) < min((s + 1) * split_len, hi)])
    return plan


def paged_attention_partial_split_ref(
    q_rows: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    li: int, tables: torch.Tensor, lengths, q_pos, *, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode body's algorithm in plain PyTorch: one f32 masked partial
    per split of :func:`decode_splits`, then the merge in the kernel's
    fixed order (the splits ascending, each weighted by exp(m_s - max)).
    Same contract as :func:`paged_attention_partial_ref`."""
    blk, nb = pool_k.shape[3], tables.shape[1]
    s, v, pos, mask = _masked_scores(q_rows, pool_k, pool_v, li, tables,
                                     lengths, q_pos, window)
    split_len = decode_split_len(blk)
    parts = []
    for sp in range(-(-nb * blk // split_len)):
        inside = (pos >= sp * split_len) & (pos < (sp + 1) * split_len)
        parts.append(_masked_partial(
            s.masked_fill(~(mask & inside), float("-inf")), [v]))
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_s, m_s, l_s in parts:       # a dead split weighs exactly 0
        w = torch.where(torch.isfinite(m_s), torch.exp(m_s - m_safe),
                        torch.zeros_like(m_s))
        acc = acc + w * acc_s
        l = l + w * l_s
    return acc, m, l


def _check(q_rows, pool_k, pool_v, li, tables) -> None:
    dev = q_rows.device
    if not (pool_k.device == pool_v.device == tables.device == dev):
        raise ValueError("q_rows, pools and tables must lie on one device")
    if q_rows.dtype not in _Q_DTYPES:
        raise TypeError(f"q_rows must be one of {_Q_DTYPES}, got "
                        f"{q_rows.dtype}")
    if pool_k.dtype not in _KV_KINDS or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"pools must share a dtype in {tuple(_KV_KINDS)}, "
                        f"got {pool_k.dtype}/{pool_v.dtype}")
    if tables.dtype != torch.int32 or tables.dim() != 2:
        raise TypeError(f"tables must be int32 [B, NB], got {tables.dtype} "
                        f"{tuple(tables.shape)}")
    if q_rows.dim() != 4 or pool_k.dim() != 5 or pool_k.shape != \
            pool_v.shape:
        raise ValueError(f"want q_rows [B,Hkv,R,D], pools [L,NBtot,Hkv,blk,"
                         f"D]; got {tuple(q_rows.shape)}, "
                         f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    b, hkv, r, d = q_rows.shape
    n_l, nbtot, phkv, blk, pd = pool_k.shape
    if phkv != hkv or pd != d or tables.shape[0] != b:
        raise ValueError(f"shape mismatch: q_rows {tuple(q_rows.shape)}, "
                         f"pool {tuple(pool_k.shape)}, tables "
                         f"{tuple(tables.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not 0 <= li < n_l:
        raise ValueError(f"layer {li} outside the pool's {n_l} layers")
    if min(b, hkv, r, tables.shape[1]) == 0:
        raise ValueError("empty paged attention extent")
    if not all(t.is_contiguous() for t in (q_rows, pool_k, pool_v, tables)):
        raise ValueError("q_rows, pools and tables must be contiguous")


def _check_rows(lengths, q_pos, b: int, device) -> None:
    """The per-row vectors as the kernel reads them: contiguous int32 [B]
    on the queries' device. The wrapper refuses anything else rather than
    converting it, so callers build them once a step, not once a layer."""
    for name, x in (("lengths", lengths), ("q_pos", q_pos)):
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.int32
                and x.shape == (b,) and x.device == device
                and x.is_contiguous()):
            desc = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
                    if isinstance(x, torch.Tensor) else type(x).__name__)
            raise TypeError(f"{name} must be a contiguous int32 [{b}] "
                            f"tensor on {device}, got {desc}")


def paged_attention_partial(
    q_rows: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    li: int, tables: torch.Tensor, lengths, q_pos, *, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partials of R query rows per kv head against layer ``li`` of
    the stacked pool, read in place through ``tables``.

    q_rows: [B, Hkv, R, D] f32 or bf16; pools: [L, NBtot, Hkv, blk, D]
    bf16, f32 or float8_e4m3fn; ``li``: layer index (an offset into the
    stacked pool: no per-layer slice is copied); tables: [B, NB] int32
    (pad ids >= NBtot are clamped and must be length-masked); lengths,
    q_pos: int32 [B] tensors on the same device (``q_pos`` is read only
    when ``window > 0``). Returns f32 (acc [B, Hkv, R, D], m [B, Hkv, R,
    1], l [B, Hkv, R, 1])."""
    if q_rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no paged attention for device {q_rows.device}")
    _check_rows(lengths, q_pos, q_rows.shape[0], q_rows.device)
    if q_rows.device.type == "cpu":
        return paged_attention_partial_ref(q_rows, pool_k, pool_v, li,
                                           tables, lengths, q_pos,
                                           window=window)
    li = int(li)
    _check(q_rows, pool_k, pool_v, li, tables)
    b, hkv, r, d = q_rows.shape
    n_l, nbtot, _, blk, _ = pool_k.shape
    nb = tables.shape[1]
    dev = q_rows.device
    acc = torch.empty((b, hkv, r, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv, r, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    body = paged_body(r, q_rows.dtype, pool_k.dtype, d, blk)
    lib = _build.library("paged_attention")
    ptrs = (q_rows.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), q_pos.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if body == "decode":
        split_len = decode_split_len(blk)
        ns = -(-nb * blk // split_len)
        part_acc = torch.empty((b, hkv, ns, r, d), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((b, hkv, ns, r, 2), dtype=torch.float32,
                              device=dev)
        err = lib.paged_attention_decode_fwd(
            *ptrs, part_acc.data_ptr(), part_ml.data_ptr(),
            b, hkv, r, d, n_l, nbtot, blk, nb, li, int(window), split_len,
            ns, stream)
    elif body == "seeded":
        err = lib.paged_attention_seeded_fwd(
            *ptrs, b, hkv, r, d, n_l, nbtot, blk, nb, li, int(window),
            stream)
    else:
        err = lib.paged_attention_fwd(
            *ptrs, b, hkv, r, d, n_l, nbtot, blk, nb, li, int(window),
            int(q_rows.dtype == torch.bfloat16), _KV_KINDS[pool_k.dtype],
            stream)
    _build.check("paged_attention", err, f"paged_attention launch ({body})")
    paged_attention_partial.launches += 1
    paged_attention_partial.launches_by_body[body] += 1
    return acc, m, l


#: kernel launches since the count was last reset (CPU calls not counted)
paged_attention_partial.launches = 0
#: K3's launches by body (:func:`paged_body`); they sum to ``launches``
paged_attention_partial.launches_by_body = dict.fromkeys(K3_BODIES, 0)
