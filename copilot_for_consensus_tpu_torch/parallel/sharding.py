"""Logical-axis → mesh-axis sharding rules — port of the JAX package's
``parallel/sharding.py``.

Model code annotates parameters with *logical* axis names
(``("vocab", "embed")``); the rules table maps those to mesh axes and
gives each leaf its spec (a tuple of mesh axes or None, one a dim: the
port's ``PartitionSpec``). Where the JAX package hands a spec to GSPMD,
``shard_views`` here slices each leaf to this rank's contiguous shard
along every sharded dim, and ``shard_pytree`` copies only that shard to
the rank's device.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

LogicalAxisRules = Mapping[str, str | tuple[str, ...] | None]

# Default serving layout: megatron-style TP over heads/ffn/vocab, batch on
# dp, sequence on sp (ring attention), experts on ep.
DEFAULT_RULES: LogicalAxisRules = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,            # replicated: activations stay whole on-chip
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "ffn": "tp",
    "vocab": "tp",
    "experts": "ep",
    "expert_ffn": "tp",
    "norm": None,
}


def serving_param_rules(cfg, mesh,
                        rules: LogicalAxisRules | None = None
                        ) -> LogicalAxisRules:
    """DEFAULT_RULES adjusted for a decoder config on a concrete mesh:
    replicate any HEAD-structured axis the tp degree does not divide.

    The fused projection leaves (``wk``/``wv``: ``[.., Hkv*Dh]``) are
    always divisible by tp in bytes, so a naive rules table shards them
    even when ``tp > n_kv_heads`` — which splits WITHIN ``head_dim``,
    where RoPE's rotate-half pairs columns ``i``/``i+Dh/2`` across the
    shard boundary. Standard GQA serving replicates KV when tp exceeds the
    kv-head count; this helper applies exactly that rule (the JAX
    package's, where the split miscompiled on its CPU partitioner)."""
    rules = dict(rules or DEFAULT_RULES)
    tp = mesh.shape.get("tp", 1)
    if tp > 1:
        if cfg.n_kv_heads % tp:
            rules["kv_heads"] = None
        if cfg.n_heads % tp:
            rules["heads"] = None
    return rules


def logical_to_spec(axes: Sequence[str | None],
                    rules: LogicalAxisRules | None = None) -> tuple:
    """The spec of one leaf: its logical axes mapped through ``rules``."""
    rules = rules or DEFAULT_RULES
    out: list[str | tuple[str, ...] | None] = []
    for ax in axes:
        if ax is None:
            out.append(None)
        elif ax in rules:
            out.append(rules[ax])
        else:
            # Fail loud: a typo'd axis name silently replicating a weight
            # is a memory blow-up, not a fallback.
            raise KeyError(f"unknown logical axis {ax!r}; rules know "
                           f"{sorted(rules)}")
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def spec_tree(logical_tree: Any,
              rules: LogicalAxisRules | None = None) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to a tree of
    specs."""
    if _is_axes(logical_tree):
        return logical_to_spec(logical_tree, rules)
    return {k: spec_tree(v, rules) for k, v in logical_tree.items()}


def shard_slices(shape: Sequence[int], spec: Sequence, mesh
                 ) -> tuple[slice, ...]:
    """This rank's contiguous shard of a leaf of ``shape`` under ``spec``:
    one slice a dim. A dim sharded over several mesh axes splits
    row-major over them, as a ``NamedSharding`` does. Raises where a
    mesh axis does not divide its dim."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {tuple(shape)}")
    out = []
    for dim, axes in zip(shape, spec):
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        parts = math.prod(mesh.shape[a] for a in names)
        if parts == 1:
            out.append(slice(None))
            continue
        if dim % parts:
            raise ValueError(
                f"mesh axes {names} ({parts} shards) do not divide a dim "
                f"of {dim} (shape {tuple(shape)}, spec {spec})")
        idx = 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        step = dim // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_leaf(x, spec: Sequence, mesh):
    """``x`` (a numpy array — a memory map is not read — or a tensor)
    sliced to this rank's shard; a view, nothing is copied. Whole leaves
    come back as they are."""
    sl = shard_slices(x.shape, spec, mesh)
    if all(s == slice(None) for s in sl):
        return x
    return x[sl]


def shard_views(tree: Any, logical_tree: Any, mesh,
                rules: LogicalAxisRules | None = None) -> Any:
    """Each leaf of ``tree`` (numpy — a memory map is not read — or torch)
    as a view of this rank's shard by its logical axes; nothing is read or
    copied."""
    specs = spec_tree(logical_tree, rules)

    def walk(node, spec, path):
        if isinstance(node, dict):
            if not isinstance(spec, dict) or set(spec) != set(node):
                raise ValueError(
                    f"logical axes at {'/'.join(path) or 'the root'} do not "
                    f"match the tree: {sorted(node)} against "
                    f"{sorted(spec) if isinstance(spec, dict) else spec}")
            return {k: walk(v, spec[k], path + (k,)) for k, v in node.items()}
        return shard_leaf(node, spec, mesh)

    return walk(tree, specs, ())


def _place(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == device:
        return x.contiguous()
    return x.to(device).contiguous()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_pytree(tree: Any, logical_tree: Any, mesh,
                 rules: LogicalAxisRules | None = None,
                 device: torch.device | None = None) -> Any:
    """Each leaf of ``tree`` (numpy or torch) sliced to this rank's shard
    by its logical axes (``shard_views``), then copied to ``device``
    (None: the mesh's): a rank never holds a whole sharded leaf on its
    device. A leaf that is whole on this rank and already on the device
    comes back as it is, with no copy."""
    device = mesh.device if device is None else torch.device(device)
    return _map(lambda x: _place(x, device),
                shard_views(tree, logical_tree, mesh, rules))
