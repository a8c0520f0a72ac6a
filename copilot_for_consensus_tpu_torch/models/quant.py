"""Weight quantization for serving (port of the JAX package's
``models/quant.py``).

Two leaf formats, scales over the contraction axis (axis -2 of every
``x @ W`` weight):

* int8 ``{"q": int8 [..., D, F], "scale": f32 [..., 1, F]}`` — one scale
  per output channel, so ``(x @ q) * scale == x @ (q * scale)``;
* int4 ``{"q4": int8 [..., D/2, F], "scale": f32 [..., G, F]}`` — signed
  nibbles packed two a byte along D (``ops.quant_matmul.pack_int4``), one
  scale per (group of D/G rows, output channel).

``layers.qmatmul`` dispatches on the leaf kind and on the process-wide
activation mode (``set_act_quant``): int8 → K2, or K4 in "a8" mode for
prefill-sized row counts; int4 → K5, or K6 in "a8" mode.
"""

from __future__ import annotations

from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.ops.quant_matmul import (
    pack_int4,
    unpack_int4,
)

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


#: weight formats: per-channel int8, group-wise packed int4
QUANT_MODES = ("int8", "int4")
#: rows per int4 scale group (small models: one group spans D)
INT4_GROUP = 256
_ACT_MODES = ("weight_only", "a8")
#: activation mode of every quantized matmul in this process: "weight_only"
#: keeps activations in their dtype, "a8" quantizes them to int8 per row
#: (``ops.quant_matmul.quantize_rows``) for the int8 tensor-core kernels
_ACT_QUANT = "weight_only"


def set_act_quant(mode: str) -> None:
    """Process-wide, as in the JAX package: "weight_only" (default) or
    "a8" (dynamic per-row int8 activations, W8A8/W4A8)."""
    if mode not in _ACT_MODES:
        raise ValueError(f"unknown act-quant mode {mode!r}")
    global _ACT_QUANT
    _ACT_QUANT = mode


def act_quant_mode() -> str:
    return _ACT_QUANT


def quantize_tensor(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric int8 over axis -2 (the contraction axis of ``x @ W``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_tensor_int4(w: torch.Tensor,
                         group: int = INT4_GROUP) -> dict[str, torch.Tensor]:
    """Symmetric int4 with one scale per ``group`` rows of the contraction
    axis and output channel (amax/7, round half to even, clip to [-8, 7]),
    packed two nibbles a byte — the JAX package's format, byte for byte."""
    *lead, d, f = w.shape
    group = min(group, d)
    if d % group:
        raise ValueError(f"contraction dim {d} not divisible by "
                         f"group {group}")
    wf = w.float().reshape(*lead, d // group, group, f)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -8, 7).reshape(*lead, d, f)
    return {"q4": pack_int4(q), "scale": scale.reshape(*lead, d // group, f)}


def dequant_int4(leaf: dict, dtype: torch.dtype) -> torch.Tensor:
    """An int4 leaf back to ``dtype`` [..., D, F] (any leading dims: the
    group axis is -2 of the scale). The oracle of the packed format; the
    serving path never materializes it."""
    q = unpack_int4(leaf["q4"])
    scale = leaf["scale"]
    s = torch.repeat_interleave(scale, q.shape[-2] // scale.shape[-2],
                                dim=-2)
    return q.to(dtype) * s.to(dtype)


def fuse_int4_projections(params: dict) -> dict:
    """Fuse the int4 q/k/v and gate/up leaves into one wide leaf each.

    q/k/v share their input x, as do gate/up, so their packed nibbles and
    group scales concatenate along the OUTPUT axis into ``wqkv``
    [L, D/2, (Hq+2Hkv)·dh] and ``w_gu`` [L, D/2, 2F] — 4 kernel calls a
    layer instead of 7. ``layers._project_qkv`` / ``layers.swiglu`` split
    the product by column; the packing along D is untouched, so the group
    scales stay exact. Already fused trees come back as they are. MoE
    trees are not fused (the engine does not call this for them, as the
    JAX engine does not): 4-D expert leaves raise."""
    layers_t = params.get("layers", {})
    if "wqkv" in layers_t or "wq" not in layers_t:
        return params
    if quant_kind(layers_t["wq"]) != "int4" or \
            quant_kind(layers_t.get("w_gate")) != "int4":
        raise ValueError("fuse_int4_projections needs int4 leaves")
    if layers_t["w_gate"]["q4"].dim() != 3:
        raise ValueError(
            "fuse_int4_projections supports dense FFN leaves only; "
            "gate fusion on cfg.is_moe at the call site")

    def cat(*leaves):
        return {k: torch.cat([leaf[k] for leaf in leaves], dim=-1)
                for k in ("q4", "scale")}

    fused = dict(layers_t)
    fused["wqkv"] = cat(layers_t["wq"], layers_t["wk"], layers_t["wv"])
    fused["w_gu"] = cat(layers_t["w_gate"], layers_t["w_up"])
    for k in ("wq", "wk", "wv", "w_gate", "w_up"):
        del fused[k]
    return {**params, "layers": fused}


def _get_path(tree: dict, path: tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def quantize_logical_axes(axes: dict,
                          leaves: tuple[tuple[str, ...], ...]
                          = DECODER_QUANT_LEAVES,
                          mode: str = "int8") -> dict:
    """Transform the logical-axes tree (``decoder.logical_axes``) to match
    a quantized param tree.

    int8: ``q`` keeps the weight's axes and the scale keeps every axis but
    the (size-1) contraction axis — a column-parallel leaf shards its
    scales with F, a row-parallel one keeps its per-channel scales whole.
    int4: ``q4`` keeps the weight's axes (packed rows shard like the rows
    they encode) and so does the scale: its group axis [G] shards like the
    contraction rows its groups scale, so a row-parallel rank holds the
    scales of its own rows. (The JAX package replicates G, which GSPMD can
    do since it computes on whole arrays; a rank here multiplies its own
    rows only.) A tp that would split a scale group raises when the tree
    is sharded."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in axes.items()}
    for path in leaves:
        t = _get_path(axes, path)
        if t is None:
            continue
        if mode == "int4":
            leaf = {"q4": t, "scale": t}
        else:
            leaf = {"q": t, "scale": tuple(
                None if i == len(t) - 2 else a for i, a in enumerate(t))}
        node = out
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = leaf
    return out


def quantize_params(params: dict,
                    leaves: tuple[tuple[str, ...], ...] = DECODER_QUANT_LEAVES,
                    mode: str = "int8", group: int = INT4_GROUP) -> dict:
    """A copy of the param tree with the given leaves quantized (``mode``:
    "int8" per-channel or "int4" group-wise packed)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    for path in leaves:
        w = _get_path(params, path)
        if w is not None:
            node = out
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = (quantize_tensor(w) if mode == "int8"
                              else quantize_tensor_int4(w, group))
    return out


def _trunc_normal(shape, fan_in: int, dtype, device,
                  gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def param_shapes(cfg: DecoderConfig) -> dict:
    """Shape tree of ``decoder.init_params``: a dense FFN, or for an MoE
    config the router [L, D, E] and the experts stacked [L, E, in, out]."""
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    hq, hkv, f, v = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    ex = (cfg.n_experts,) if cfg.is_moe else ()
    layer = {
        "attn_norm": (n, d), "wq": (n, d, hq * dh),
        "wk": (n, d, hkv * dh), "wv": (n, d, hkv * dh),
        "wo": (n, hq * dh, d), "ffn_norm": (n, d),
    }
    if cfg.is_moe:
        layer["router"] = (n, d, cfg.n_experts)
    layer.update({"w_gate": (n, *ex, d, f), "w_up": (n, *ex, d, f),
                  "w_down": (n, *ex, f, d)})
    shapes = {"tok_emb": (v, d), "layers": layer, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_random_quantized(cfg: DecoderConfig, *, seed: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          device: torch.device | str | None = None,
                          leaves: tuple[tuple[str, ...], ...]
                          = DECODER_QUANT_LEAVES,
                          mode: str = "int8",
                          group: int = INT4_GROUP) -> dict:
    """Random decoder params with the quantized leaves born int8 (or
    packed int4, ``mode="int4"``) on the device (None → the card), from a
    ``torch.Generator`` seeded with ``seed``.

    The full-precision weights are never made. int8 values are drawn
    uniform in [-127, 127] (std ≈ 73.3); int4 leaves are random packed
    bytes, each nibble uniform in [-8, 7] (std ≈ 4.61), with ``group``-row
    scale groups. Either way the scale is set so the dequantized weight
    has std ≈ 1/sqrt(fan_in) — the JAX package's rule. Norms are ones; the
    other leaves (an MoE router among them) are truncated normal /
    sqrt(fan_in) in ``dtype``. MoE experts are born quantized with the
    expert axis leading: int8 ``q`` [L, E, D, F] with scale [L, E, 1, F],
    int4 ``q4`` [L, E, D/2, F] with scale [L, E, G, F].
    """
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    quant_set = set(leaves)

    def build(names: tuple[str, ...], shape: tuple[int, ...]):
        if names in quant_set and mode == "int4":
            fan_in = shape[-2]
            g = min(group, fan_in)
            q4 = torch.randint(-128, 128, (*shape[:-2], fan_in // 2,
                                           shape[-1]), generator=gen,
                               dtype=torch.int8, device=device)
            scale = torch.full((*shape[:-2], fan_in // g, shape[-1]),
                               fan_in ** -0.5 / 4.61, dtype=torch.float32,
                               device=device)
            return {"q4": q4, "scale": scale}
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
