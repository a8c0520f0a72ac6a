"""K1: flash attention — wrapper of ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/flash_attention.py``
``flash_attention`` (body ``_flash_kernel``) with the same contract:
q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]`` in bf16 or f32, GQA (kv
head ``h // (Hq // Hkv)``), causal and sliding-window masks, and per-row
int32 ``kv_lengths`` / ``q_offsets`` / ``kv_begins``. Scores, softmax
statistics and the accumulator are f32; the output is in q's dtype; a
query row with no attendable key emits zeros.

``flash_attention`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors — on no other condition.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _row_params(b: int, s_kv: int, kv_lengths, q_offsets, kv_begins,
                device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three per-row int32 vectors, defaulted as the TPU kernel
    defaults them (full length, offset 0, begin 0)."""
    def vec(x, fill):
        if x is None:
            return torch.full((b,), fill, dtype=torch.int32, device=device)
        x = torch.as_tensor(x, device=device).to(torch.int32)
        if x.shape != (b,):
            raise ValueError(f"per-row vector must be [{b}], got "
                             f"{tuple(x.shape)}")
        return x.contiguous()
    return (vec(kv_lengths, s_kv), vec(q_offsets, 0), vec(kv_begins, 0))


def _mask(b: int, s_q: int, s_kv: int, lens, offs, begins, *, causal: bool,
          window: int, device) -> torch.Tensor:
    """Boolean [B, Sq, Skv]; True = attend (the TPU kernel's rule)."""
    q_pos = offs[:, None, None] + torch.arange(
        s_q, device=device)[None, :, None]
    k_pos = torch.arange(s_kv, device=device)[None, None, :]
    mask = (k_pos < lens[:, None, None]) & (k_pos >= begins[:, None, None])
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        kv_lengths=None, q_offsets=None,
                        kv_begins=None) -> torch.Tensor:
    """Plain version of K1 on any device: f32 scores over the whole
    [Sq, Skv] extent, one softmax, zeros for fully-masked rows."""
    b, hq, s_q, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    g = hq // hkv
    lens, offs, begins = _row_params(b, s_kv, kv_lengths, q_offsets,
                                     kv_begins, q.device)
    mask = _mask(b, s_q, s_kv, lens, offs, begins, causal=causal,
                 window=window, device=q.device)
    qg = q.float().reshape(b, hkv, g, s_q, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (d ** -0.5)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)   # fully-masked rows
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s_q, d).to(q.dtype)


def _check(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v must share a dtype in {_DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,Sq,D], k=v [B,Hkv,Skv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s_q, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if min(b, hq, s_q, k.shape[2]) == 0:
        raise ValueError("empty attention extent")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, kv_lengths=None,
                    q_offsets=None, kv_begins=None) -> torch.Tensor:
    """q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D] → [B, Hq, Sq, D] in q's
    dtype. ``q_offsets`` [B] place each row's queries at an offset in the
    kv timeline; ``kv_begins`` [B] mask a kv prefix; ``kv_lengths`` [B]
    mask the padded kv tail."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_lengths=kv_lengths,
                                   q_offsets=q_offsets, kv_begins=kv_begins)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    _check(q, k, v)
    b, hq, s_q, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    lens, offs, begins = _row_params(b, s_kv, kv_lengths, q_offsets,
                                     kv_begins, q.device)
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), offs.data_ptr(), begins.data_ptr(),
        b, hq, hkv, s_q, s_kv, d, int(causal), int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_attention launch")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last reset (CPU calls not counted)
flash_attention.launches = 0
