"""Time how fast weight-shaped tensors stream through each conversion a
quantized matmul body makes, on the card.

The port of ``scripts/probe_stream.py``: L distinct [D, F] int8 (or packed
int4 [D/2, F]) weight tensors, each larger than the card's 50 MB L2, are
run at decode batch B through one kernel call each, the output folded back
to [B, D] so the layers chain. Modes (kernel P, ``ops/probe_stream.py``):

  dma       every weight byte is read, one row a tile is summed: the
            ceiling of a weight-shaped read (the bound of every decode
            matmul)
  convdot   int8 tile -> bf16 -> bf16 tensor-core product (K2's body)
  i8dot     native int8 tensor-core product, scaled at the end (K4's body)
  unpack8   packed int4 -> nibbles unpacked as bytes -> int8 products per
            scale group (K6's body)
  unpack32  the same, the nibbles widened through int32

Each mode runs N = 10 chained passes to warm up, then N timed passes
between CUDA events; the card sleeps while the host enqueues the timed
passes, so the events time the card, not the host. One line per mode: ms a
pass, weight GB/s and the share of the card's 3.35 TB/s.

Usage: python -m copilot_for_consensus_tpu_torch.scripts.probe_stream
       [mode ...]
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.ops import probe_stream as probe

B, D, F, L = 128, 4096, 14336, 20
GROUP = 256
#: the reference's column and contraction blocks
BF, BD = 512, 2048
N = 10
MODES = ("dma", "convdot", "i8dot", "unpack8", "unpack32")
HBM_BYTES_PER_S = 3.35e12
#: the fastest SM clock of an H100 (1.98 GHz), for sizing the card's sleep
_MAX_CLOCK_HZ = 2e9


def weights_from_numpy(w, device=None) -> torch.Tensor:
    """A weight stack made elsewhere (the JAX build's, through
    ``np.asarray``) as a contiguous int8 tensor on ``device`` (``None`` is
    the card)."""
    arr = np.array(w, dtype=np.int8, order="C", copy=True)
    return torch.from_numpy(arr).to(resolve_device(device))


def build(mode: str, *, b: int = B, d: int = D, f: int = F, n_layers: int = L,
          bd: int = BD, bf: int = BF, group: int = GROUP, device=None):
    """The reference's ``build(mode)``: a seeded weight stack [L, D, F]
    int8 in [-127, 127] (dma, convdot, i8dot) or [L, D/2, F] packed bytes
    in [-128, 127] (unpack*), made on ``device`` (``None`` is the card),
    and ``step_n(w, x, n)``: n passes of ``y = probe(x, w[l]);
    x = tanh(y[:, :D] · 1e-2)`` over the layers, x bf16 [B, D]. ``bf``, the
    TPU's column block, does not change the function; F must be a whole
    number of them, as in the reference's grid."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if f % bf or d % bd or f < d:
        raise ValueError(f"shapes D={d}, F={f} need D % bd == 0, "
                         f"F % bf == 0 and F >= D (bd={bd}, bf={bf})")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mode in ("dma", "convdot", "i8dot"):
        w = torch.randint(-127, 128, (n_layers, d, f), generator=gen,
                          dtype=torch.int8, device=dev)
        kern = {"dma": probe.probe_dma, "convdot": probe.probe_convdot,
                "i8dot": probe.probe_i8dot}[mode]

        def one(x, wl):
            return kern(x, wl, bd)
    else:
        w = torch.randint(-128, 128, (n_layers, d // 2, f), generator=gen,
                          dtype=torch.int8, device=dev)
        gdp, bdp = group // 2, bd // 2
        if group % 2 or bdp % gdp:
            raise ValueError(f"group {group} must be even and divide bd "
                             f"{bd}")
        widen = mode == "unpack32"

        def one(x, wl):
            return probe.probe_unpack(x, wl, widen=widen, gdp=gdp,
                                      groups=bdp // gdp)

    # the reference multiplies bf16 by the Python scalar 1e-2, which JAX
    # rounds to bf16 first
    scale = torch.tensor(1e-2, dtype=torch.bfloat16, device=dev)

    def step_n(w: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
        for _ in range(n):
            for wl in w:
                x = torch.tanh(one(x, wl)[:, :d] * scale)
        return x

    return w, step_n


def _enqueued(fn, *args) -> tuple[float, object]:
    t0 = time.monotonic()
    out = fn(*args)
    return time.monotonic() - t0, out


def run(mode: str, *, device=None) -> dict:
    """Build ``mode`` at the reference's sizes, warm up with N passes and
    time N more; print the mode's line and return its numbers. ``ms`` is
    the card's time a pass; ``enqueued_ahead`` says whether the host had
    enqueued every timed pass before the card left its sleep (if not, host
    gaps may be inside)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the probe times the card: run it on a CUDA device")
    w, step_n = build(mode, device=dev)
    gb = w.numel() * w.element_size() / 1e9
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    t0 = time.monotonic()
    y, per_pass = x, []
    for _ in range(N):                  # the warm-up, a pass at a time
        t, y = _enqueued(step_n, w, y, 1)
        per_pass.append(t)
    torch.cuda.synchronize(dev)
    warm_s = time.monotonic() - t0
    # the card sleeps at least 1.5x the time the host took to enqueue N
    # warm passes (the median pass: the first may build the kernel) while
    # the host enqueues the timed passes behind the start event
    enqueue_guess = sorted(per_pass)[N // 2] * N
    torch.cuda._sleep(int(_MAX_CLOCK_HZ * 1.5 * enqueue_guess))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    enqueue_s, out = _enqueued(step_n, w, x, N)
    end.record()
    ahead = not start.query()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / N
    row = {"mode": mode, "ms": dt * 1e3, "gb": gb, "gb_per_s": gb / dt,
           "share_of_hbm": gb * 1e9 / dt / HBM_BYTES_PER_S,
           "enqueued_ahead": ahead, "enqueue_s": enqueue_s,
           "warm_s": warm_s, "mean_abs_out": float(out.float().abs().mean()),
           "passes": N, "layers": w.shape[0]}
    print(f"{mode:10s}  {row['ms']:.4f} ms   {row['gb_per_s']:.1f} GB/s "
          f"({gb:.4f} GB, {row['share_of_hbm']:.4f} of 3.35 TB/s, warm-up "
          f"{warm_s:.2f}s, |out|={row['mean_abs_out']:.3g}, enqueued ahead "
          f"{ahead})", flush=True)
    return row


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> list[dict]:
    modes = (sys.argv[1:] if argv is None else argv) or list(MODES)
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m!r}; one of {MODES}")
    resolve_device(None)
    print(f"device: {card()}, B={B} D={D} F={F} L={L} (per-pass bytes = "
          f"one [D,F] tensor x L)", flush=True)
    rows = []
    for m in modes:
        rows.append(run(m))
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
