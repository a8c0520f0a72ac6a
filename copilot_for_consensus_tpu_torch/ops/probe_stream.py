"""The weight-stream probe's kernel P: wrappers of ``csrc/probe_stream.cu``
and their plain PyTorch versions.

It replaces the Pallas bodies of ``scripts/probe_stream.py`` (``k_dma``,
``k_convdot``, ``k_i8dot``, ``k_unpack``), which time how fast a
weight-shaped tensor streams through each conversion a quantized matmul
body makes:

* ``probe_dma``: every byte of w is read; the output is one sampled row a
  ``bd``-row tile, summed, plus the first column of x's last ``bd`` block;
* ``probe_convdot``: int8 → bf16, then a bf16 product (K2's body);
* ``probe_i8dot``: x truncated to int8, a native int8 product (K4's body);
* ``probe_unpack``: packed int4 nibbles unpacked to int8 (``widen=False``,
  byte operations) or through int32 (``widen=True``), int8 products per
  scale group (K6's body).

The block sizes of the reference are part of the function: ``bd`` picks
dma's sampled rows and x column and convdot's f32 summation tiles; ``gdp``
(packed rows a group) and ``groups`` (groups a tile) pick each unpack
group's scale ``1e-4 · (g + 1)``, g counted within its tile.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors — on no other condition — and counts its launches
in ``<wrapper>.launches``. On the card convdot, i8dot and unpack have two
bodies, chosen from shape alone by :func:`probe_body`: ``"wgmma"``, the
Hopper weight stream of ``csrc/probe_wgmma.cuh`` (every layout of the
probe script), and ``"simple"``, the first mma.sync body with its
workspace and second launch, for the layouts the first refuses; each
counts its launches in ``<wrapper>.launches_by_body``. A failure of either
raises; neither falls back to the other.
"""

from __future__ import annotations

import torch

from copilot_for_consensus_tpu_torch.ops import _build
from copilot_for_consensus_tpu_torch.ops.quant_matmul import unpack_int4

#: the reference's blocks: the contraction block, and for int4 the packed
#: rows a scale group (GROUP 256 // 2) and groups a tile (bdp 1024 // 128)
BD = 2048
GDP = 128
GROUPS = 8
#: unpacked rows a k-step of the CUDA kernel's int8 tile: a contraction
#: tile (bd, or 2 · gdp unpacked rows a group) is a whole number of them
KSTEP = 64
_MODES = {"dma": 0, "convdot": 1, "i8dot": 2, "unpack8": 3, "unpack32": 4}
#: the bodies of convdot, i8dot and unpack, the keys of their wrappers'
#: ``launches_by_body``
P_BODIES = ("wgmma", "simple")
#: the Hopper body's tiles (``csrc/probe_wgmma.cuh``): tokens (one wgmma
#: N), columns a cluster (two CTAs of 128), and unpacked contraction rows a
#: stage (convdot's bd and unpack's group of 2 · gdp must be whole stages;
#: i8dot's D)
WGMMA_TOKENS = 128
WGMMA_COLS = 256
WGMMA_KSTEP = {"convdot": 64, "i8dot": 128, "unpack8": 128,
               "unpack32": 128}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, w: torch.Tensor, rows: int) -> None:
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"x must be bf16 [B, D], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if w.dtype != torch.int8 or w.dim() != 2:
        raise TypeError(f"w must be int8 [rows, F], got {w.dtype} "
                        f"{tuple(w.shape)}")
    if w.shape[0] != rows:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}: {rows} rows expected")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def _check_packed(x: torch.Tensor, w4: torch.Tensor) -> None:
    _check(x, w4, x.shape[1] // 2)
    if x.shape[1] != 2 * w4.shape[0]:
        raise ValueError(f"x's width {x.shape[1]} must be twice w4's "
                         f"{w4.shape[0]} packed rows")


def _tiles(d: int, tile: int) -> int:
    if tile <= 0 or d % tile:
        raise ValueError(f"the contraction {d} is not a whole number of "
                         f"{tile}-row tiles")
    return d // tile


def quantize_x16(x: torch.Tensor) -> torch.Tensor:
    """unpack's activations: ``clip(round_half_even(f32(x) · 16), ±127)``
    as int8."""
    return torch.clamp(torch.round(x.float() * 16), -127, 127).to(torch.int8)


def unpack_scales(groups: int, device) -> torch.Tensor:
    """f32 ``1e-4 · (g + 1)`` for g < groups, each product taken in f64
    and rounded once to f32, as the reference's Python float is."""
    return torch.tensor([1e-4 * (g + 1) for g in range(groups)],
                        dtype=torch.float32, device=device)


def dma_ref(x: torch.Tensor, w: torch.Tensor, bd: int = BD) -> torch.Tensor:
    """Plain version of dma: ``bf16(Σ_t w[t·bd] + x[:, (D/bd − 1)·bd])``,
    the integer sum exact in f32."""
    _check(x, w, x.shape[1])
    d = x.shape[1]
    _tiles(d, bd)
    rows = w[::bd].float().sum(0)                       # exact integers
    return (rows[None, :] + x[:, d - bd:d - bd + 1].float()).to(
        torch.bfloat16)


def convdot_ref(x: torch.Tensor, w: torch.Tensor,
                bd: int = BD) -> torch.Tensor:
    """Plain version of convdot: ``bf16(Σ_t x[:, t] @ bf16(w[t]))`` with an
    f32 product a ``bd`` tile (bf16 × int8 products are exact in f32) and
    the tiles summed in order."""
    _check(x, w, x.shape[1])
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for t in range(_tiles(x.shape[1], bd)):
        sl = slice(t * bd, (t + 1) * bd)
        acc = acc + x[:, sl].float() @ w[sl].float()
    return acc.to(torch.bfloat16)


def i8dot_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of i8dot: ``xi = x`` truncated to int8, then
    ``bf16(f32(xi @ w) · 1e-4)``. The integer sum is taken in f64, which
    holds it exactly (|acc| ≤ 127²·D < 2^53), because torch has no int32
    matmul on CUDA; its rounding to f32 is the int32 accumulator's."""
    _check(x, w, x.shape[1])
    xi = x.to(torch.int8)
    acc = (xi.double() @ w.double()).float()
    return (acc * 1e-4).to(torch.bfloat16)


def unpack_ref(x: torch.Tensor, w4: torch.Tensor, gdp: int = GDP,
               groups: int = GROUPS) -> torch.Tensor:
    """Plain version of unpack (both unpackings): for each tile of
    ``gdp · groups`` packed rows, each group's exact integer product of
    ``quantize_x16(x)`` and its unpacked rows (f64), rounded to f32 and
    scaled by ``1e-4 · (g + 1)``, summed in group order into the tile's
    part; the parts summed in tile order, rounded to bf16."""
    _check_packed(x, w4)
    bdp = gdp * groups
    xq = quantize_x16(x).double()
    scales = unpack_scales(groups, x.device)
    acc = torch.zeros(x.shape[0], w4.shape[1], dtype=torch.float32,
                      device=x.device)
    for t in range(_tiles(w4.shape[0], bdp)):
        part = torch.zeros_like(acc)
        for g in range(groups):
            r0 = t * bdp + g * gdp
            wg = unpack_int4(w4[r0:r0 + gdp]).double()
            pg = (xq[:, 2 * r0:2 * (r0 + gdp)] @ wg).float()
            part = part + pg * scales[g]
        acc = acc + part
    return acc.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def probe_body(mode: str, b: int, d: int, f: int, bd: int = BD,
               gdp: int = GDP, groups: int = GROUPS) -> str:
    """The body of P's ``mode`` (convdot, i8dot, unpack8 or unpack32) that a
    CUDA call runs, from shape alone: ``"wgmma"`` (the Hopper weight stream)
    where B is one token tile (1-128), F whole clusters of columns and the
    contraction whole stages — convdot's ``bd`` tile, i8dot's D, unpack's
    group of ``2 · gdp`` rows — else ``"simple"`` (the mma.sync body).
    ``d`` is x's width; ``bd`` is read by convdot, ``gdp`` and ``groups``
    by unpack.
    The reference's layout (B 128, D 4096, F 14336, bd 2048, gdp 128) is
    ``"wgmma"`` in every mode."""
    if mode not in WGMMA_KSTEP:
        raise ValueError(f"no Hopper body for probe mode {mode!r}; one of "
                         f"{tuple(WGMMA_KSTEP)}")
    ks = WGMMA_KSTEP[mode]
    if not (1 <= b <= WGMMA_TOKENS and d >= 1 and f >= 1
            and f % WGMMA_COLS == 0):
        return "simple"
    if mode == "convdot":
        ok = bd >= ks and bd % ks == 0 and d % bd == 0
    elif mode == "i8dot":
        ok = d % ks == 0
    else:
        ok = (gdp >= ks // 2 and (2 * gdp) % ks == 0 and groups >= 1
              and d % (2 * gdp * groups) == 0)
    return "wgmma" if ok else "simple"


def _launch(mode: str, x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
            bd: int = 0, gdp: int = 0, groups: int = 0) -> torch.Tensor:
    b, d = x.shape
    f = w.shape[1]
    if f % (16 if mode == "dma" else 8):
        raise ValueError(f"probe {mode} on CUDA needs F % "
                         f"{16 if mode == 'dma' else 8} == 0, got F={f}")
    out = torch.empty((b, f), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("probe_stream")
    err = lib.probe_stream_fwd(
        _MODES[mode], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, d, f, bd, gdp, groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("probe_stream", err, f"probe {mode} launch")
    return out


def _wgmma(mode: str, x: torch.Tensor, w: torch.Tensor, bd: int = 0,
           gdp: int = 0, groups: int = 0) -> torch.Tensor:
    """One call of the Hopper body: for i8dot and unpack a pre-pass makes
    int8 x into scratch made here, then the body runs; convdot reads x as
    it is (one launch)."""
    b, d = x.shape
    f = w.shape[1]
    out = torch.empty((b, f), dtype=torch.bfloat16, device=x.device)
    xq = None if mode == "convdot" else torch.empty(
        (b, d), dtype=torch.int8, device=x.device)
    lib = _build.library("probe_stream")
    err = lib.probe_stream_wgmma_fwd(
        _MODES[mode], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        xq.data_ptr() if xq is not None else None, b, d, f, bd, gdp, groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("probe_stream", err, f"probe {mode} launch (wgmma)")
    return out


def simple_body(mode: str, x: torch.Tensor, w: torch.Tensor, bd: int = BD,
                gdp: int = GDP, groups: int = GROUPS) -> torch.Tensor:
    """The mma.sync body of convdot, i8dot, unpack8 or unpack32 on CUDA
    tensors (a [tiles, B, F] workspace made here, then two launches),
    whatever the layout; the wrappers run it where :func:`probe_body` says
    ``"simple"``. Counts nothing itself."""
    tile = 2 * gdp * groups if mode.startswith("unpack") else bd
    tiles = _tiles(x.shape[1], tile)
    _kstep(mode, 2 * gdp if mode.startswith("unpack") else bd)
    ws = torch.empty((tiles, x.shape[0], w.shape[1]),
                     dtype=torch.int32 if mode == "i8dot" else torch.float32,
                     device=x.device)
    if mode.startswith("unpack"):
        return _launch(mode, x, w, ws, gdp=gdp, groups=groups)
    return _launch(mode, x, w, ws, bd=bd)


def _run(mode: str, x: torch.Tensor, w: torch.Tensor, bd: int = BD,
         gdp: int = GDP, groups: int = GROUPS) -> tuple[torch.Tensor, str]:
    body = probe_body(mode, x.shape[0], x.shape[1], w.shape[1], bd, gdp,
                      groups)
    if body == "wgmma":
        return _wgmma(mode, x, w, bd, gdp, groups), body
    return simple_body(mode, x, w, bd, gdp, groups), body


def _on_card(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no probe {name} for device {x.device}")


def _kstep(name: str, rows: int) -> None:
    if rows % KSTEP:
        raise ValueError(f"probe {name} on CUDA needs a tile of a multiple "
                         f"of {KSTEP} rows, got {rows}")


def probe_dma(x: torch.Tensor, w: torch.Tensor,
              bd: int = BD) -> torch.Tensor:
    """dma: x bf16 [B, D], w int8 [D, F] → bf16 [B, F] (see ``dma_ref``);
    on the card every byte of w is read."""
    if x.device.type == "cpu":
        return dma_ref(x, w, bd)
    _on_card(x, "dma")
    _check(x, w, x.shape[1])
    tiles = _tiles(x.shape[1], bd)
    ws = torch.empty((tiles, w.shape[1]), dtype=torch.float32,
                     device=x.device)
    out = _launch("dma", x, w, ws, bd=bd)
    probe_dma.launches += 1
    return out


def probe_convdot(x: torch.Tensor, w: torch.Tensor,
                  bd: int = BD) -> torch.Tensor:
    """convdot: x bf16 [B, D], w int8 [D, F] → ``bf16(x @ bf16(w))``."""
    if x.device.type == "cpu":
        return convdot_ref(x, w, bd)
    _on_card(x, "convdot")
    _check(x, w, x.shape[1])
    _tiles(x.shape[1], bd)
    out, body = _run("convdot", x, w, bd=bd)
    probe_convdot.launches += 1
    probe_convdot.launches_by_body[body] += 1
    return out


def probe_i8dot(x: torch.Tensor, w: torch.Tensor,
                bd: int = BD) -> torch.Tensor:
    """i8dot: x bf16 [B, D] (truncated to int8 by the kernel), w int8
    [D, F] → ``bf16(f32(xi @ w) · 1e-4)``. ``bd`` is the kernel's
    contraction tile; the exact integer result does not depend on it."""
    if x.device.type == "cpu":
        return i8dot_ref(x, w)
    _on_card(x, "i8dot")
    _check(x, w, x.shape[1])
    _tiles(x.shape[1], bd)
    out, body = _run("i8dot", x, w, bd=bd)
    probe_i8dot.launches += 1
    probe_i8dot.launches_by_body[body] += 1
    return out


def probe_unpack(x: torch.Tensor, w4: torch.Tensor, widen: bool = False,
                 gdp: int = GDP, groups: int = GROUPS) -> torch.Tensor:
    """unpack: x bf16 [B, D] (quantized by the kernel), w4 packed int4
    [D/2, F] → bf16 [B, F] (see ``unpack_ref``). ``widen`` picks how the
    kernel unpacks the nibbles — in the int8 domain or through int32 — and
    does not change the output."""
    if x.device.type == "cpu":
        return unpack_ref(x, w4, gdp, groups)
    _on_card(x, "unpack")
    _check_packed(x, w4)
    _tiles(w4.shape[0], gdp * groups)
    out, body = _run("unpack32" if widen else "unpack8", x, w4, gdp=gdp,
                     groups=groups)
    probe_unpack.launches += 1
    probe_unpack.launches_by_body[body] += 1
    return out


#: kernel launches since the count was last reset (CPU calls not counted)
probe_dma.launches = 0
probe_convdot.launches = 0
probe_i8dot.launches = 0
probe_unpack.launches = 0
#: launches by body (:func:`probe_body`); they sum to ``launches``
probe_convdot.launches_by_body = dict.fromkeys(P_BODIES, 0)
probe_i8dot.launches_by_body = dict.fromkeys(P_BODIES, 0)
probe_unpack.launches_by_body = dict.fromkeys(P_BODIES, 0)
