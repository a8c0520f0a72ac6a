"""Weight-only int8 quantization for serving (port of the int8 parts of
the JAX package's ``models/quant.py``).

Per-output-channel symmetric scales over the contraction axis (axis -2 of
every ``x @ W`` weight), so ``(x @ q) * scale == x @ (q * scale)``. A
quantized leaf is the dict ``{"q": int8 [..., D, F], "scale": f32
[..., 1, F]}``; ``layers.qmatmul`` sends it to K2 (``ops/quant_matmul``).
"""

from __future__ import annotations

from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig

# Decoder leaves quantized by default: every matmul weight. Embedding
# gather and norms stay in the activation dtype.
DECODER_QUANT_LEAVES = (
    ("layers", "wq"), ("layers", "wk"), ("layers", "wv"), ("layers", "wo"),
    ("layers", "w_gate"), ("layers", "w_up"), ("layers", "w_down"),
    ("lm_head",),
)


def is_quantized(leaf: Any) -> bool:
    return (isinstance(leaf, dict) and "scale" in leaf
            and ("q" in leaf or "q4" in leaf))


def quant_kind(leaf: Any) -> str | None:
    """None for plain tensors, else "int8" / "int4"."""
    if not isinstance(leaf, dict) or "scale" not in leaf:
        return None
    if "q4" in leaf:
        return "int4"
    if "q" in leaf:
        return "int8"
    return None


def quantize_tensor(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric int8 over axis -2 (the contraction axis of ``x @ W``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _get_path(tree: dict, path: tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def quantize_params(params: dict,
                    leaves: tuple[tuple[str, ...], ...] = DECODER_QUANT_LEAVES,
                    mode: str = "int8") -> dict:
    """A copy of the param tree with the given leaves int8-quantized."""
    if mode != "int8":
        raise ValueError(f"unsupported quantization mode {mode!r}")
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    for path in leaves:
        w = _get_path(params, path)
        if w is not None:
            node = out
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = quantize_tensor(w)
    return out


def _trunc_normal(shape, fan_in: int, dtype, device,
                  gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def param_shapes(cfg: DecoderConfig) -> dict:
    """Shape tree of ``decoder.init_params`` (dense FFN)."""
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    hq, hkv, f, v = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    shapes = {
        "tok_emb": (v, d),
        "layers": {
            "attn_norm": (n, d), "wq": (n, d, hq * dh),
            "wk": (n, d, hkv * dh), "wv": (n, d, hkv * dh),
            "wo": (n, hq * dh, d), "ffn_norm": (n, d),
            "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d),
        },
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_random_quantized(cfg: DecoderConfig, *, seed: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          device: torch.device | str | None = None,
                          leaves: tuple[tuple[str, ...], ...]
                          = DECODER_QUANT_LEAVES) -> dict:
    """Random decoder params with the quantized leaves born int8 on the
    device (None → the card), from a ``torch.Generator`` seeded with
    ``seed``.

    The full-precision 7B weights are never made: int8 values are drawn
    uniform in [-127, 127] (std ≈ 73.3) and the scale is set so the
    dequantized weight has std ≈ 1/sqrt(fan_in) — the JAX package's rule.
    Norms are ones; the other leaves are truncated normal / sqrt(fan_in).
    """
    if cfg.is_moe:
        raise NotImplementedError("the port serves dense decoders only")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    quant_set = set(leaves)

    def build(names: tuple[str, ...], shape: tuple[int, ...]):
        if names in quant_set:
            fan_in = shape[-2]
            q = torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8, device=device)
            scale = torch.full((*shape[:-2], 1, shape[-1]),
                               fan_in ** -0.5 / 73.3, dtype=torch.float32,
                               device=device)
            return {"q": q, "scale": scale}
        if "norm" in names[-1]:
            return torch.ones(shape, dtype=dtype, device=device)
        fan_in = shape[-1] if names[-1] == "tok_emb" else (
            shape[-2] if len(shape) >= 2 else shape[-1])
        return _trunc_normal(shape, fan_in, dtype, device, gen)

    def walk(tree: dict, prefix: tuple[str, ...]) -> dict:
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else build(prefix + (k,), v) for k, v in tree.items()}

    return walk(param_shapes(cfg), ())


def param_bytes(params: dict) -> int:
    """Device bytes held by a param tree."""
    total = 0
    for v in params.values():
        if isinstance(v, dict):
            total += param_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total
