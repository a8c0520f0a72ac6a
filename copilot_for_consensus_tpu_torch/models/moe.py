"""Mixture-of-experts FFN, Mixtral class (softmax top-k routing) — port of
the JAX package's ``models/moe.py``.

Capacity-based dispatch as in GShard/Switch: each expert takes at most
``moe_capacity(T)`` (token, choice) rows a call, counted choice-major
(choice 0 of every token before any choice 1), and the rows past it are
dropped. The JAX package builds dense one-hot dispatch/combine tensors
[T, E, C] and contracts them; here each kept row is scattered into its
capacity slot of ``expert_in`` [E, C, D] and the experts' outputs are
gathered back from their slots. Every (expert, slot) is written at most
once, so both give the same numbers. Shapes are static — no ``nonzero``,
no boolean-mask indexing, no host sync — so the layer captures into the
decode CUDA graphs; every expert runs every call, on empty slots too, as
in the JAX package.

Expert products take the weight-only route whatever the activation mode
(``layers.wmatmul``): an int8 expert is one K2 call a matrix, an int4
expert one K5 call, on the contiguous ``[D, F]`` slice of the stacked
leaf — 3·E calls a layer.

On a tp mesh each expert holds a rank's shard of its ``expert_ffn``
columns (w_gate, w_up) and rows (w_down); routing and capacity are whole
on every rank, and the combine's output is a partial sum the decoder
completes with one tp all-reduce after it. ``ep`` is 1, and an MoE
engine refuses dp above 1: expert capacity spans the whole batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from copilot_for_consensus_tpu_torch.models import layers as L
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import quant_kind
from copilot_for_consensus_tpu_torch.ops.attention import _matmul_f32


def moe_capacity(n_tokens: int, cfg: DecoderConfig) -> int:
    """Slots an expert has for ``n_tokens`` tokens (padding included):
    ``cf · T · k / E`` truncated, rounded up to a multiple of 8, at
    least 8."""
    cap = int(cfg.expert_capacity_factor * n_tokens
              * cfg.experts_per_token / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def moe_route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits, renormalized top-k gates and expert ids of the rows
    ``xt`` [T, D]. Returns (logits [T, E] f32, gate_vals [T, k] f32,
    gate_idx [T, k] int64).

    An f32 router (a checkpoint's) routes in f32 — x is promoted first,
    as JAX's type promotion does; a router in x's dtype computes in it and
    the logits are then cast to f32. Softmax in f32; ties between equal
    probabilities go to the lower expert id (``jax.lax.top_k``'s order),
    by a stable descending sort."""
    if router.dtype == torch.float32 and xt.dtype != torch.float32:
        logits = xt.float() @ router
    else:
        logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return logits, vals / vals.sum(dim=-1, keepdim=True), idx


def _expert_leaf(w: dict, e: int) -> dict:
    """Expert ``e``'s slice of a stacked quantized leaf: a contiguous
    ``[D, F]`` (or packed ``[D/2, F]``) weight and its scale rows."""
    key = "q4" if "q4" in w else "q"
    return {key: w[key][e], "scale": w["scale"][e]}


def moe_ffn(x: torch.Tensor, layer: dict, cfg: DecoderConfig,
            impl: str = "auto") -> torch.Tensor:
    """x: [B, S, D] → [B, S, D]. layer: router [D, E]; w_gate/w_up
    [E, D, F]; w_down [E, F, D] (plain tensors, or int8/int4 leaves with
    the expert axis leading). ``impl="plain"`` takes the plain versions
    of the quantized experts' kernels."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(t, cfg)
    xt = x.reshape(t, d)
    _, gate_vals, gate_idx = moe_route(xt, layer["router"], k)

    # choice-major flattening: row i is choice i // T of token i % T, so
    # top-1 choices win capacity over top-2 spill-over
    flat_idx = gate_idx.T.reshape(-1)                            # [k·T]
    onehot = (flat_idx[:, None] == torch.arange(e, device=x.device)
              ).to(torch.int32)
    pos = onehot.cumsum(0).gather(1, flat_idx[:, None])[:, 0] - 1
    # a kept row's capacity slot; dropped rows go to the row E·C, the
    # dump on the way in and zeros on the way out
    slot = torch.where(pos < cap, flat_idx * cap + pos,
                       torch.full_like(pos, e * cap))
    tok = torch.arange(k * t, device=x.device) % t
    expert_in = x.new_zeros(e * cap + 1, d)
    expert_in[slot] = xt[tok]
    expert_in = expert_in[:e * cap].reshape(e, cap, d)

    out_rows = x.new_zeros(e * cap + 1, d)
    if quant_kind(layer["w_gate"]) is None:
        gate = F.silu(_matmul_f32(expert_in, layer["w_gate"]))
        up = _matmul_f32(expert_in, layer["w_up"])
        out_rows[:e * cap] = torch.bmm(
            (gate * up).to(x.dtype), layer["w_down"]).reshape(e * cap, d)
    else:
        for j in range(e):
            a = expert_in[j]
            gate = F.silu(L.wmatmul(a, _expert_leaf(layer["w_gate"], j),
                                    impl).float())
            up = L.wmatmul(a, _expert_leaf(layer["w_up"], j), impl).float()
            out_rows[j * cap:(j + 1) * cap] = L.wmatmul(
                (gate * up).to(x.dtype), _expert_leaf(layer["w_down"], j),
                impl)

    # combine: each choice's output row (zeros if dropped) times its gate
    # in x's dtype, summed over the k choices in f32, rounded once
    g = gate_vals.T.reshape(-1).to(x.dtype).float()
    out = (out_rows[slot].float() * g[:, None]).reshape(k, t, d).sum(0)
    return out.to(x.dtype).reshape(b, s, d)


def moe_load_balancing_loss(router_logits: torch.Tensor,
                            gate_idx: torch.Tensor,
                            n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E · Σ_e (fraction of tokens whose
    first choice is e) · (mean probability of e)``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_tokens = F.one_hot(gate_idx[..., 0], n_experts).float().mean(0)
    frac_probs = probs.mean(0)
    return n_experts * (frac_tokens * frac_probs).sum()
