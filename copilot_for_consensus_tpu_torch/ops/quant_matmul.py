"""K2: int8 weight-only matmul — wrapper of ``csrc/int8_matmul.cu`` and
its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/quant_matmul.py``
``int8_matmul`` (body ``_kernel``): ``x[..., D] @ q[D, F] * scale[1, F]``
with x in bf16 or f32, the int8 weight converted in registers, f32
accumulation, the per-output-channel scale applied in f32 once at the
end, and the output in x's dtype. PyTorch has no dequant-fused matmul:
``x @ q.to(bf16)`` writes a bf16 copy of the weight and reads it back —
three times the int8 bytes on a decode step that is bound by them.

``int8_matmul`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors — on no other condition.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
#: rows up to which the kernel takes its weight-streaming (GEMV) path. This
#: module alone decides the path: the kernel runs GEMV when it is given
#: splits > 0 (it is built for M = 1 .. 8) and the tiled path for splits = 0.
GEMV_MAX_M = 8
#: GEMV path: output columns per block and the block count it aims for
_GEMV_COLS = 256
_GEMV_BLOCKS = 512
_GEMV_MIN_ROWS = 16


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 on any device: f32 product of x and the int8
    weight, scaled in f32, rounded once to x's dtype."""
    f = q.shape[-1]
    acc = x.float() @ q.float()
    return (acc * scale.reshape(f).float()).to(x.dtype)


def gemv_splits(m: int, d: int, f: int) -> int:
    """Contraction-axis splits of the GEMV path (0 for the tiled path):
    enough blocks to keep the card's memory busy when F is narrow, each
    split at least 16 rows deep. Partials go to an f32 workspace
    [splits, M, F] that a second pass sums in a fixed order."""
    if m > GEMV_MAX_M:
        return 0
    col_tiles = -(-f // _GEMV_COLS)
    return max(1, min(d // _GEMV_MIN_ROWS, -(-_GEMV_BLOCKS // col_tiles)))


def _check(x, q, scale) -> None:
    if not (x.device == q.device == scale.device):
        raise ValueError("x, q, scale must lie on one device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be int8 [D, F], got {q.dtype} "
                        f"{tuple(q.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != q.shape[1]:
        raise TypeError(f"scale must be f32 [1, F={q.shape[1]}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if x.shape[-1] != q.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ q "
                         f"{tuple(q.shape)}")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, q, scale must be contiguous")


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scale)`` with q int8. x: [..., D]; q: [D, F]; scale:
    [1, F] f32. Returns [..., F] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul for device {x.device}")
    _check(x, q, scale)
    d, f = q.shape
    m = x.numel() // d
    out = torch.empty(*x.shape[:-1], f, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    splits = gemv_splits(m, d, f)
    ws = torch.empty((splits, m, f), dtype=torch.float32,
                     device=x.device) if splits else None
    lib = _build.library("int8_matmul")
    err = lib.int8_matmul_fwd(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        m, d, f, splits, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("int8_matmul", err, "int8_matmul launch")
    int8_matmul.launches += 1
    return out


#: kernel launches since the count was last reset (CPU calls not counted)
int8_matmul.launches = 0
