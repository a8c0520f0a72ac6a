"""Quantized matmuls: the wrappers of the CUDA kernels K2, K5, K4 and K6
and their plain PyTorch versions.

Each replaces a Pallas kernel of the JAX package's ``ops/quant_matmul.py``:

* K2 ``int8_matmul`` (``csrc/int8_matmul.cu``, Pallas body ``_kernel``):
  ``x[..., D] @ q[D, F] * scale[1, F]`` with x in bf16 or f32, the int8
  weight converted on chip, f32 accumulation, the per-output-channel
  scale applied in f32 once at the end. PyTorch has no dequant-fused
  matmul: ``x @ q.to(bf16)`` writes a bf16 copy of the weight and reads it
  back — three times the int8 bytes on a decode step that is bound by
  them. Five bodies, chosen by :func:`int8_body` from dtype and shape
  alone: the Hopper weight stream of ``csrc/int8_stream.cuh`` for decode,
  the Hopper wgmma GEMM of ``csrc/int8_wgmma.cuh`` for the prefill
  extents, the split GEMV for decode layouts the stream does not take and
  for f32 x, a WMMA tiling for tiled layouts the wgmma body does not take,
  and a CUDA-core loop for f32 x.
* K5 ``int4_matmul`` (``csrc/int4_matmul.cu``, ``_kernel4``): the weight
  is signed int4, two nibbles a byte along the contraction axis
  (``pack_int4``), with one f32 scale per (group of D/G rows, column);
  each group's f32 partial product is scaled before it is accumulated.
  Five bodies, chosen by :func:`int4_body` from dtype and shape alone:
  the Hopper weight stream of ``csrc/int4_stream.cuh`` for decode, the
  Hopper wgmma GEMM of ``csrc/int4_wgmma.cuh`` for the prefill extents,
  the mma.sync tiling and the split streaming path of
  ``csrc/quant_mma.cuh`` for layouts those two do not take, and a
  CUDA-core loop for f32 x.
* K4 ``w8a8_matmul`` (``csrc/w8a8_matmul.cu``, ``_kernel_w8a8``): x is
  quantized to int8 per row (``quantize_rows``), the int8 product is
  summed in int32, and the output is ``acc · sx · sw``. Two bodies, chosen
  by :func:`w8a8_body` from shape alone: the Hopper int8 wgmma GEMM of
  ``csrc/w8a8_wgmma.cuh`` where D is whole 128-row stages and F a multiple
  of 16 (every Mistral-7B int8 leaf), else the mma.sync tiling of
  ``csrc/quant_mma.cuh``.
* K6 ``w4a8_matmul`` (``csrc/w4a8_matmul.cu``, ``_kernel_w4a8``): K5's
  weight layout with K4's int8 activations; each group's int32 partial is
  scaled in f32 by the group scale, the sum by sx at the end. Four
  bodies, chosen by :func:`w4a8_body` from shape alone: the Hopper weight
  stream of ``csrc/w4a8_stream.cuh`` for decode, the Hopper int8 wgmma
  GEMM of ``csrc/w4a8_wgmma.cuh`` for the prefill extents, and, for
  layouts those two do not take, the split streaming path (decode) and
  the mma.sync tiling (prefill) of ``csrc/quant_mma.cuh``.

Each plain version computes what the Pallas kernel computes (not the JAX
package's XLA fallbacks, which round the dequantized weight to x's
dtype). Each wrapper runs its plain version for CPU tensors and launches
its kernel for CUDA tensors — on no other condition — and counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
#: rows up to which K2 takes its decode bodies: the stream body
#: (``int8_stream.cuh``, bf16 x, planned by :func:`int8_stream_plan`) or,
#: for f32 x and layouts the stream refuses, the split GEMV. This module
#: alone decides the body: ``int8_matmul_fwd`` runs the GEMV when it is
#: given splits > 0 (it is built for M = 1 .. 8) and the tiled path for
#: splits = 0.
GEMV_MAX_M = 8
#: K2's stream body: output columns a CTA (its tiles), contraction rows a
#: stage (D must be whole stages), the column multiple its TMA loads need
#: (a 16-byte row pitch), and the CTAs it aims for (one an SM on 132 SMs)
K2_STREAM_TN = 128
K2_STREAM_KSTEP = 128
K2_STREAM_COLS = 16
_K2_STREAM_SLOTS = 132
#: split GEMV: output columns per block and the block count it aims for
_GEMV_COLS = 256
_GEMV_BLOCKS = 512
_GEMV_MIN_ROWS = 16
#: rows up to which K5 (bf16 x) and K6 take their decode paths: their
#: stream bodies (``int4_stream.cuh``, ``w4a8_stream.cuh``, both planned by
#: :func:`stream_plan`: the packed layout is the same), or, for layouts
#: those bodies refuse, the split ``qgemm``. The split ``qgemm`` is a
#: 32-row tile split over the contraction axis by whole scale groups
#: (:func:`stream_splits`); its kernels run it when given splits > 0 and
#: their 128-row prefill tiling for splits = 0. Decided here alone. The
#: two stream bodies share K2's split counters (:func:`_counters`), one
#: set a CUDA stream.
STREAM_MAX_M = 32
_STREAM_COLS = 128        # the split qgemm's output columns per block
_STREAM_BLOCKS = 528      # blocks the split aims for: 4 per SM on 132 SMs
#: K5's stream body: output columns a CTA (its tiles; K6's stream body's
#: too), unpacked contraction rows a stage (a scale group must be whole
#: stages), the column multiple its TMA loads need (a 16-byte row pitch),
#: and the CTAs both stream bodies aim to keep resident (two an SM on 132
#: SMs)
STREAM_TN = 128
K5_STREAM_KSTEP = 128
K5_STREAM_COLS = 16
_STREAM_SLOTS = 264
#: unpacked contraction rows per k-step of the CUDA kernels: K5's bf16
#: tile (32 rows) and K4's / K6's int8 tile (64 rows). A scale group must
#: be a whole number of steps, and D a multiple of the step.
K5_KSTEP = 32
A8_KSTEP = 64
#: K5's wgmma body (``csrc/int4_wgmma.cuh``): unpacked contraction rows a
#: stage (a scale group must be whole stages), and the column multiple its
#: TMA loads of the packed weight need (a 16-byte row pitch)
K5_WGMMA_KSTEP = 64
K5_WGMMA_COLS = 16
#: K5's bodies, the keys of ``int4_matmul.launches_by_body``
K5_BODIES = ("stream", "wgmma", "mma_sync", "split", "simt")
#: K2's wgmma body (``csrc/int8_wgmma.cuh``): contraction rows a stage (D
#: must be whole stages) and the column multiple its TMA loads of the
#: weight need (a 16-byte row pitch)
K2_WGMMA_KSTEP = 64
K2_WGMMA_COLS = 16
#: K2's bodies, the keys of ``int8_matmul.launches_by_body``
K2_BODIES = ("stream", "gemv", "wgmma", "wmma", "simt")
#: K6's wgmma body (``csrc/w4a8_wgmma.cuh``): contraction rows a stage (D
#: and the scale group must be whole stages), and the column multiple its
#: TMA loads of the packed weight need (a 16-byte row pitch)
K6_WGMMA_KSTEP = 128
K6_WGMMA_COLS = 16
#: K6's stream body (``csrc/w4a8_stream.cuh``): unpacked contraction rows
#: a stage (a scale group must be whole stages) and the column multiple
#: its TMA loads of the packed weight need (a 16-byte row pitch)
K6_STREAM_KSTEP = 128
K6_STREAM_COLS = 16
#: K6's bodies, the keys of ``w4a8_matmul.launches_by_body``
K6_BODIES = ("stream", "wgmma", "mma_sync", "split")
#: K4's wgmma body (``csrc/w8a8_wgmma.cuh``): contraction rows a stage (D
#: must be whole stages) and the column multiple its TMA loads of the
#: weight need (a 16-byte row pitch)
K4_WGMMA_KSTEP = 128
K4_WGMMA_COLS = 16
#: K4's bodies, the keys of ``w8a8_matmul.launches_by_body``
K4_BODIES = ("wgmma", "mma_sync")
#: K2's wgmma body takes 256-column tiles where they make at least this
#: many CTAs (one wave on 132 SMs), else 128-column ones: the wider tile
#: reads x from L2 half as often, the narrower keeps the SMs busy when F
#: is narrow (the k/v projections' 1024) or the rows few
K2_WIDE_MIN_TILES = 132


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., D, F] signed nibble values in [-8, 7] → [..., D//2, F] packed
    int8: byte row i holds row 2i in its low nibble and row 2i+1 in its
    high nibble (the JAX package's layout, byte for byte)."""
    d = q.shape[-2]
    if d % 2:
        raise ValueError(f"contraction dim must be even, got {d}")
    q = q.to(torch.int32)
    byte = ((q[..., 1::2, :] & 0xF) << 4) | (q[..., 0::2, :] & 0xF)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [..., D//2, F] int8 → [..., D, F]
    int32. The low nibble sign-extends as ``((p & 0xF) ^ 8) - 8``; the
    high one is an arithmetic shift of the signed byte."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    stacked = torch.stack([lo, hi], dim=-2)          # [..., D/2, 2, F]
    return stacked.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                           packed.shape[-1])


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: [..., D] → (int8 [..., D], f32 [..., 1]).
    Bit for bit the JAX package's: scale amax/127 (1 for an all-zero row),
    true division by it, rounding half to even, a clip to ±127.

    The divisor 127 is a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can land one ulp off."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                     torch.ones_like(amax))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _int4_groups(d: int, q4: torch.Tensor, scale: torch.Tensor) -> int:
    """Validate an int4 operand pair against x's depth ``d``; returns the
    group size D // G."""
    dp, g = q4.shape[-2], scale.shape[-2]
    if d != 2 * dp:
        raise ValueError(f"x depth {d} != 2x packed rows {dp}")
    if d % g:
        raise ValueError(f"group count {g} must divide D {d}")
    return d // g


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 on any device: f32 product of x and the int8
    weight, scaled in f32, rounded once to x's dtype."""
    f = q.shape[-1]
    acc = x.float() @ q.float()
    return (acc * scale.reshape(f).float()).to(x.dtype)


def int8_matmul_stream_ref(x: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor,
                           rows_per_split: int) -> torch.Tensor:
    """K2's stream body in its order of operations, on any device: the
    contraction cut into splits of ``rows_per_split`` rows; each split's
    f32 product of x's columns and the int8 rows; the splits' partials
    added in split order; the sum times the per-column scale in f32; one
    rounding to x's dtype. With one split it is :func:`int8_matmul_ref`."""
    d, f = q.shape
    xm = x.reshape(-1, d).float()
    total = None
    for r0 in range(0, d, rows_per_split):
        part = xm[:, r0:r0 + rows_per_split] @ \
            q[r0:r0 + rows_per_split].float()
        total = part if total is None else total + part
    out = total * scale.reshape(f).float()
    return out.to(x.dtype).reshape(*x.shape[:-1], f)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on any device: for each scale group, the f32
    product of x's columns and the group's unpacked rows, scaled in f32
    by the group's scale row and summed; rounded once to x's dtype."""
    d = x.shape[-1]
    group = _int4_groups(d, q4, scale)
    f = q4.shape[-1]
    xm = x.reshape(-1, d).float()
    acc = torch.zeros(xm.shape[0], f, dtype=torch.float32, device=x.device)
    for g in range(scale.shape[0]):
        w = unpack_int4(q4[g * group // 2:(g + 1) * group // 2]).float()
        acc += (xm[:, g * group:(g + 1) * group] @ w) * scale[g].float()
    return acc.to(x.dtype).reshape(*x.shape[:-1], f)


def int4_matmul_stream_ref(x: torch.Tensor, q4: torch.Tensor,
                           scale: torch.Tensor, per: int) -> torch.Tensor:
    """K5's stream body in its order of operations, on any device: the
    groups cut into splits of ``per`` whole groups; in each split, each
    group's f32 partial product times its scale row, summed from zero in
    group order; the splits' sums added in split order; one rounding to
    x's dtype. With one split it is :func:`int4_matmul_ref`."""
    d = x.shape[-1]
    group = _int4_groups(d, q4, scale)
    f, g = q4.shape[-1], scale.shape[0]
    xm = x.reshape(-1, d).float()
    total = None
    for g0 in range(0, g, per):
        acc = torch.zeros(xm.shape[0], f, dtype=torch.float32,
                          device=x.device)
        for gi in range(g0, min(g, g0 + per)):
            w = unpack_int4(q4[gi * group // 2:(gi + 1) * group // 2]).float()
            acc += (xm[:, gi * group:(gi + 1) * group] @ w) * scale[gi].float()
        total = acc if total is None else total + acc
    return total.to(x.dtype).reshape(*x.shape[:-1], f)


def w8a8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 on any device: ``quantize_rows(x)``, the int8
    product summed exactly, then ``(acc · sx) · sw`` in f32. The integer
    sum is taken in f64, which holds it exactly (|acc| ≤ 127²·D < 2^53),
    because torch has no int32 matmul on CUDA; its rounding to f32 is the
    int32 accumulator's."""
    d, f = q.shape
    xq, sx = quantize_rows(x.reshape(-1, d))
    acc = (xq.double() @ q.double()).float()
    out = acc * sx * scale.reshape(1, f).float()
    return out.to(x.dtype).reshape(*x.shape[:-1], f)


def w4a8_matmul_ref(x: torch.Tensor, q4: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 on any device: ``quantize_rows(x)``; for each
    scale group the exact integer product of the int8 columns and the
    group's unpacked rows (in f64, as in K4's plain version), rounded to
    f32 and scaled by the group's scale row; the sum times sx."""
    d = x.shape[-1]
    group = _int4_groups(d, q4, scale)
    f = q4.shape[-1]
    xq, sx = quantize_rows(x.reshape(-1, d))
    xq = xq.double()
    acc = torch.zeros(xq.shape[0], f, dtype=torch.float32, device=x.device)
    for g in range(scale.shape[0]):
        w = unpack_int4(q4[g * group // 2:(g + 1) * group // 2]).double()
        pg = (xq[:, g * group:(g + 1) * group] @ w).float()
        acc += pg * scale[g].float()
    return (acc * sx).to(x.dtype).reshape(*x.shape[:-1], f)


def w4a8_matmul_stream_ref(x: torch.Tensor, q4: torch.Tensor,
                           scale: torch.Tensor, per: int) -> torch.Tensor:
    """K6's stream body in its order of operations, on any device:
    ``quantize_rows(x)``; the groups cut into splits of ``per`` whole
    groups; in each split, each group's exact integer product (in f64, as
    in :func:`w4a8_matmul_ref`) rounded to f32 and times its scale row,
    summed from zero in group order; the splits' sums added in split
    order; the total times sx, rounded once to x's dtype. With one split
    it is :func:`w4a8_matmul_ref`."""
    d = x.shape[-1]
    group = _int4_groups(d, q4, scale)
    f, g = q4.shape[-1], scale.shape[0]
    xq, sx = quantize_rows(x.reshape(-1, d))
    xq = xq.double()
    total = None
    for g0 in range(0, g, per):
        acc = torch.zeros(xq.shape[0], f, dtype=torch.float32,
                          device=x.device)
        for gi in range(g0, min(g, g0 + per)):
            w = unpack_int4(q4[gi * group // 2:(gi + 1) * group // 2]) \
                .double()
            pg = (xq[:, gi * group:(gi + 1) * group] @ w).float()
            acc += pg * scale[gi].float()
        total = acc if total is None else total + acc
    return (total * sx).to(x.dtype).reshape(*x.shape[:-1], f)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def gemv_splits(m: int, d: int, f: int) -> int:
    """Contraction-axis splits of K2's split GEMV (0 for the tiled path):
    enough blocks to keep the card's memory busy when F is narrow, each
    split at least 16 rows deep. Partials go to an f32 workspace
    [splits, M, F] that a second pass sums in a fixed order."""
    if m > GEMV_MAX_M:
        return 0
    col_tiles = -(-f // _GEMV_COLS)
    return max(1, min(d // _GEMV_MIN_ROWS, -(-_GEMV_BLOCKS // col_tiles)))


def stream_splits(m: int, groups: int, f: int) -> int:
    """Contraction-axis splits of the split ``qgemm`` — K5's and K6's
    decode path for layouts their stream bodies refuse (0 for the tiled
    path): whole scale groups per split, enough splits to put about
    ``_STREAM_BLOCKS`` blocks in flight, and none empty. Partials go to an
    f32 workspace [splits, M, F] summed in a fixed order by a second pass."""
    if m > STREAM_MAX_M:
        return 0
    col_tiles = -(-f // _STREAM_COLS)
    want = max(1, min(groups, -(-_STREAM_BLOCKS // col_tiles)))
    per = -(-groups // want)
    return -(-groups // per)


def stream_plan(m: int, d: int, f: int, groups: int) -> tuple[int, int, int]:
    """The grid of K5's and K6's stream bodies: (column tile width,
    splits, whole groups a split). Tiles are ``STREAM_TN`` columns; the
    contraction is split by whole groups only as far as it takes to bring
    the CTAs toward ``_STREAM_SLOTS`` (all resident at once), and no
    further than keeps the f32 workspace (splits × M × F × 4 bytes) at
    most a quarter of the packed weight's bytes (D/2 × F). No split is
    empty."""
    tiles = -(-f // STREAM_TN)
    cap = max(1, min(groups, _STREAM_SLOTS // tiles, d // (32 * max(m, 1))))
    per = -(-groups // cap)
    return STREAM_TN, -(-groups // per), per


def int8_stream_plan(m: int, d: int, f: int) -> tuple[int, int, int]:
    """The grid of K2's stream body: (column tile width, splits,
    contraction rows a split). Tiles are ``K2_STREAM_TN`` columns; the
    contraction is split by whole ``K2_STREAM_KSTEP``-row stages only as
    far as it takes to bring the CTAs toward ``_K2_STREAM_SLOTS`` (one an
    SM), and no further than keeps the f32 workspace (splits × M × F × 4
    bytes) at most a quarter of the weight's bytes (D × F). So a leaf
    splits unless its tiles alone fill more than half the slots (F >
    8448). No split is empty."""
    tiles = -(-f // K2_STREAM_TN)
    stages = d // K2_STREAM_KSTEP
    cap = max(1, min(stages, _K2_STREAM_SLOTS // tiles,
                     d // (16 * max(m, 1))))
    per = -(-stages // cap)
    return K2_STREAM_TN, -(-stages // per), per * K2_STREAM_KSTEP


def int8_body(m: int, d: int, f: int, dtype: torch.dtype) -> str:
    """The body of K2 that a CUDA call runs, from dtype and shape alone:
    up to ``GEMV_MAX_M`` rows ``"stream"`` (the Hopper weight stream) for
    bf16 x where D is whole 128-row stages and F a multiple of 16, else
    ``"gemv"`` (the split GEMV, and for f32 x); above it ``"simt"`` (the
    CUDA-core loop) for f32 x, and for bf16 x ``"wgmma"`` (the Hopper GEMM)
    where D is whole 64-row stages and F a multiple of 16, else
    ``"wmma"``. Every Mistral-7B int8 projection is ``"stream"`` at M <= 8
    and ``"wgmma"`` above."""
    if m <= GEMV_MAX_M:
        if dtype == torch.bfloat16 and d % K2_STREAM_KSTEP == 0 \
                and f % K2_STREAM_COLS == 0:
            return "stream"
        return "gemv"
    if dtype != torch.bfloat16:
        return "simt"
    if d % K2_WGMMA_KSTEP == 0 and f % K2_WGMMA_COLS == 0:
        return "wgmma"
    return "wmma"


def int8_tile_n(m: int, f: int) -> int:
    """Output columns of a tile of K2's wgmma body (128-row tiles): 256
    where 256-wide tiles number ``K2_WIDE_MIN_TILES`` or more, else 128."""
    wide = -(-m // 128) * -(-f // 256)
    return 256 if wide >= K2_WIDE_MIN_TILES else 128


def int4_body(m: int, f: int, group: int, dtype: torch.dtype) -> str:
    """The body of K5 that a CUDA call runs, from dtype and shape alone:
    ``"simt"`` (the CUDA-core loop) for f32 x at every M; for bf16 x up to
    ``STREAM_MAX_M`` rows ``"stream"`` (the Hopper weight stream) where the
    scale group is whole 128-row stages and F a multiple of 16, else
    ``"split"`` (the split qgemm K6 shares); above it ``"wgmma"`` (the
    Hopper GEMM) where the scale group is whole 64-row stages and F a
    multiple of 16, else ``"mma_sync"`` (the tiling K4 and K6 share).
    Every Mistral-7B int4 projection (group 256) is ``"stream"`` at
    M <= 32 and ``"wgmma"`` above."""
    if dtype != torch.bfloat16:
        return "simt"
    if m <= STREAM_MAX_M:
        if group % K5_STREAM_KSTEP == 0 and f % K5_STREAM_COLS == 0:
            return "stream"
        return "split"
    if group % K5_WGMMA_KSTEP == 0 and f % K5_WGMMA_COLS == 0:
        return "wgmma"
    return "mma_sync"


def w4a8_body(m: int, d: int, f: int, group: int,
              dtype: torch.dtype) -> str:
    """The body of K6 that a CUDA call runs, from shape alone: up to
    ``STREAM_MAX_M`` rows ``"stream"`` (the Hopper weight stream) where the
    scale group is whole 128-row stages and F a multiple of 16, else
    ``"split"`` (the split qgemm K5 shares); above it ``"wgmma"`` (the
    Hopper int8 GEMM) where D and the scale group are whole 128-row stages
    and F a multiple of 16, else ``"mma_sync"`` (the tiling K4 and K5
    share). ``dtype`` (bf16 or f32) does not enter: every body multiplies
    the int8 rows ``quantize_rows`` makes of x, and x's dtype changes only
    the store, so both take the same body. Every Mistral-7B int4
    projection (group 256) is ``"stream"`` at M <= 32 and ``"wgmma"``
    above."""
    if dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {dtype}")
    if m <= STREAM_MAX_M:
        if group % K6_STREAM_KSTEP == 0 and f % K6_STREAM_COLS == 0:
            return "stream"
        return "split"
    if d % K6_WGMMA_KSTEP == 0 and group % K6_WGMMA_KSTEP == 0 \
            and f % K6_WGMMA_COLS == 0:
        return "wgmma"
    return "mma_sync"


def w8a8_body(m: int, d: int, f: int, dtype: torch.dtype) -> str:
    """The body of K4 that a CUDA call runs, from shape alone: ``"wgmma"``
    (the Hopper int8 GEMM) where D is whole 128-row stages and F a
    multiple of 16, else ``"mma_sync"`` (the tiling K5 and K6 share).
    Neither ``m`` nor ``dtype`` (bf16 or f32) enters: both bodies multiply
    the int8 rows ``quantize_rows`` makes of x at any M, and x's dtype
    changes only the store. Every Mistral-7B int8 projection is
    ``"wgmma"``."""
    if dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {dtype}")
    if d % K4_WGMMA_KSTEP == 0 and f % K4_WGMMA_COLS == 0:
        return "wgmma"
    return "mma_sync"


def _check(x, w, scale, w_rows: int) -> None:
    if not (x.device == w.device == scale.device):
        raise ValueError("x, weight, scale must lie on one device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    if w.dtype != torch.int8 or w.dim() != 2:
        raise TypeError(f"weight must be int8 [rows, F], got {w.dtype} "
                        f"{tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.shape[-1] != w.shape[1]:
        raise TypeError(f"scale must be f32 [.., F={w.shape[1]}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if x.shape[-1] != w_rows:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ "
                         f"weight {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, weight, scale must be contiguous")


def _check_kernel_shape(name: str, d: int, f: int, kstep: int,
                        group: int | None = None) -> None:
    """What the CUDA kernels take beyond the function's own contract:
    16-byte rows of x, 4-byte weight rows, whole k-steps per group."""
    if d % kstep or f % 8:
        raise ValueError(f"{name} on CUDA needs D % {kstep} == 0 and "
                         f"F % 8 == 0, got D={d}, F={f}")
    if group is not None and group % kstep:
        raise ValueError(f"{name} on CUDA needs a group size that is a "
                         f"multiple of {kstep}, got {group}")


def _stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _stream(x: torch.Tensor) -> int:
    return _stream_of(x.device)


#: per (device, CUDA stream), the split counters of the stream bodies of
#: K2, K5 and K6 (one int32 a column tile), which share them: zero
#: between launches, since the last CTA of a tile resets its own. Launches
#: in one stream run in order, so they never use one set at once; two
#: streams run side by side (the long-context engine's generate on a
#: caller's thread while the async runner replays decode graphs), so each
#: stream has a set of its own.
_stream_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device, _stream_of(device))
    c = _stream_counters.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _stream_counters[key] = c
    return c


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scale)`` with q int8. x: [..., D]; q: [D, F]; scale:
    [1, F] f32. Returns [..., F] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul for device {x.device}")
    _check(x, q, scale, q.shape[0])
    if scale.numel() != q.shape[1]:
        raise TypeError(f"scale must be f32 [1, F={q.shape[1]}]")
    d, f = q.shape
    m = x.numel() // d
    out = torch.empty(*x.shape[:-1], f, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    body = int8_body(m, d, f, x.dtype)
    lib = _build.library("int8_matmul")
    if body == "wgmma":
        err = lib.int8_matmul_wgmma_fwd(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, d, f, int8_tile_n(m, f), _stream(x))
    elif body == "stream":
        tn, splits, rows = int8_stream_plan(m, d, f)
        ws = cnt = None
        if splits > 1:
            ws = torch.empty((splits, m, f), dtype=torch.float32,
                             device=x.device)
            cnt = _counters(x.device, -(-f // tn))
        err = lib.int8_matmul_stream_fwd(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None,
            m, d, f, tn, splits, rows, _stream(x))
    else:
        splits = gemv_splits(m, d, f)
        ws = torch.empty((splits, m, f), dtype=torch.float32,
                         device=x.device) if splits else None
        err = lib.int8_matmul_fwd(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            m, d, f, splits, int(x.dtype == torch.bfloat16), _stream(x))
    _build.check("int8_matmul", err, f"int8_matmul launch ({body})")
    int8_matmul.launches += 1
    int8_matmul.launches_by_body[body] += 1
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q4, scale)``. x: [..., D] bf16 or f32; q4: packed
    int8 [D/2, F]; scale: f32 [G, F], group D/G. Returns [..., F] in x's
    dtype."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int4 matmul for device {x.device}")
    _check(x, q4, scale, 2 * q4.shape[0])
    d, f, g = x.shape[-1], q4.shape[1], scale.shape[0]
    group = _int4_groups(d, q4, scale)
    _check_kernel_shape("int4_matmul", d, f, K5_KSTEP, group)
    m = x.numel() // d
    out = torch.empty(*x.shape[:-1], f, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    body = int4_body(m, f, group, x.dtype)
    lib = _build.library("int4_matmul")
    if body == "wgmma":
        err = lib.int4_matmul_wgmma_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, d, f, g, _stream(x))
    elif body == "stream":
        tn, splits, per = stream_plan(m, d, f, g)
        ws = cnt = None
        if splits > 1:
            ws = torch.empty((splits, m, f), dtype=torch.float32,
                             device=x.device)
            cnt = _counters(x.device, -(-f // tn))
        err = lib.int4_matmul_stream_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None,
            m, d, f, g, tn, splits, per, _stream(x))
    else:
        splits = stream_splits(m, g, f) if body == "split" else 0
        ws = torch.empty((splits, m, f), dtype=torch.float32,
                         device=x.device) if splits else None
        err = lib.int4_matmul_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            m, d, f, g, splits, int(x.dtype == torch.bfloat16), _stream(x))
    _build.check("int4_matmul", err, f"int4_matmul launch ({body})")
    int4_matmul.launches += 1
    int4_matmul.launches_by_body[body] += 1
    return out


def _a8_scratch(x: torch.Tensor, m: int, d: int):
    return (torch.empty((m, d), dtype=torch.int8, device=x.device),
            torch.empty((m,), dtype=torch.float32, device=x.device))


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``quantize_rows(x) @ q`` in int32, times sx and scale. x: [..., D]
    bf16 or f32; q: int8 [D, F]; scale: f32 [1, F]. Returns [..., F] in x's
    dtype. The kernel quantizes x itself, into scratch made here."""
    if x.device.type == "cpu":
        return w8a8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no w8a8 matmul for device {x.device}")
    _check(x, q, scale, q.shape[0])
    if scale.numel() != q.shape[1]:
        raise TypeError(f"scale must be f32 [1, F={q.shape[1]}]")
    d, f = q.shape
    _check_kernel_shape("w8a8_matmul", d, f, A8_KSTEP)
    m = x.numel() // d
    out = torch.empty(*x.shape[:-1], f, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    xq, sx = _a8_scratch(x, m, d)
    body = w8a8_body(m, d, f, x.dtype)
    lib = _build.library("w8a8_matmul")
    fwd = lib.w8a8_matmul_wgmma_fwd if body == "wgmma" \
        else lib.w8a8_matmul_fwd
    err = fwd(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
              xq.data_ptr(), sx.data_ptr(), m, d, f,
              int(x.dtype == torch.bfloat16), _stream(x))
    _build.check("w8a8_matmul", err, f"w8a8_matmul launch ({body})")
    w8a8_matmul.launches += 1
    w8a8_matmul.launches_by_body[body] += 1
    return out


def w4a8_matmul(x: torch.Tensor, q4: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``quantize_rows(x) @ dequant(q4, scale)`` with int32 group dots.
    Same operands as :func:`int4_matmul`. The kernel quantizes x itself,
    into scratch made here."""
    if x.device.type == "cpu":
        return w4a8_matmul_ref(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no w4a8 matmul for device {x.device}")
    _check(x, q4, scale, 2 * q4.shape[0])
    d, f, g = x.shape[-1], q4.shape[1], scale.shape[0]
    group = _int4_groups(d, q4, scale)
    _check_kernel_shape("w4a8_matmul", d, f, A8_KSTEP, group)
    m = x.numel() // d
    out = torch.empty(*x.shape[:-1], f, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    xq, sx = _a8_scratch(x, m, d)
    body = w4a8_body(m, d, f, group, x.dtype)
    lib = _build.library("w4a8_matmul")
    if body == "wgmma":
        err = lib.w4a8_matmul_wgmma_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), m, d, f, g,
            int(x.dtype == torch.bfloat16), _stream(x))
    elif body == "stream":
        tn, splits, per = stream_plan(m, d, f, g)
        ws = cnt = None
        if splits > 1:
            ws = torch.empty((splits, m, f), dtype=torch.float32,
                             device=x.device)
            cnt = _counters(x.device, -(-f // tn))
        err = lib.w4a8_matmul_stream_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None,
            m, d, f, g, tn, splits, per,
            int(x.dtype == torch.bfloat16), _stream(x))
    else:
        splits = stream_splits(m, g, f)
        ws = torch.empty((splits, m, f), dtype=torch.float32,
                         device=x.device) if splits else None
        err = lib.w4a8_matmul_fwd(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            m, d, f, g, splits, int(x.dtype == torch.bfloat16), _stream(x))
    _build.check("w4a8_matmul", err, f"w4a8_matmul launch ({body})")
    w4a8_matmul.launches += 1
    w4a8_matmul.launches_by_body[body] += 1
    return out


#: kernel launches since the count was last reset (CPU calls not counted)
int8_matmul.launches = 0
#: K2's launches by body (:func:`int8_body`); they sum to ``launches``
int8_matmul.launches_by_body = dict.fromkeys(K2_BODIES, 0)
int4_matmul.launches = 0
#: K5's launches by body (:func:`int4_body`); they sum to ``launches``
int4_matmul.launches_by_body = dict.fromkeys(K5_BODIES, 0)
w8a8_matmul.launches = 0
#: K4's launches by body (:func:`w8a8_body`); they sum to ``launches``
w8a8_matmul.launches_by_body = dict.fromkeys(K4_BODIES, 0)
w4a8_matmul.launches = 0
#: K6's launches by body (:func:`w4a8_body`); they sum to ``launches``
w4a8_matmul.launches_by_body = dict.fromkeys(K6_BODIES, 0)
