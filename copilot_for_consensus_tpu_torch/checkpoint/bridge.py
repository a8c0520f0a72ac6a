"""Param trees from numpy: the bridge between the two packages' weights.

``params_from_numpy`` takes a decoder or encoder param tree whose leaves
are numpy arrays — the JAX package's tree after ``np.asarray`` on every
leaf, quantized leaves included (int8 ``{"q", "scale"}``, packed int4
``{"q4", "scale"}``) — or CPU torch tensors (a checkpoint read by
``checkpoint/native.py`` or ``checkpoint/hf.py``), and returns the port's
tree on ``device``: the
int8 bytes of ``q`` and ``q4`` stay int8, ``scale`` is f32, an MoE
``router`` keeps the dtype it arrives in (a checkpoint's f32 router routes
in f32, as the JAX engine keeps it; a random-init one is already in the
activation dtype), and every other leaf is cast to ``dtype``. Layouts are the same in both packages, so the
same weights drive both. A torch leaf moves to the device before it is
cast, so a leaf mapped from a file reaches the card with one copy.

With a ``mesh`` (and the decoder's ``cfg``) each leaf is first cut to this
rank's shard by the serving rules (``parallel.sharding``): a mapped leaf
is sliced before anything is read or copied, so a rank's device never
holds a whole sharded leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype


#: leaves that hold int8 bytes: cast to the activation dtype, packed
#: nibbles would be destroyed. No encoder leaf bears one of these names
#: (nor "scale" or "router"), so an encoder tree is cast to ``dtype``
#: whole.
_INT8_LEAVES = ("q", "q4")
#: leaves that keep the dtype they arrive in
_KEEP_DTYPE = ("router",)


def params_from_numpy(tree: dict[str, Any], device, dtype, mesh=None, *,
                      cfg=None) -> dict:
    device = resolve_device(device, mesh)
    dtype = resolve_dtype(dtype)
    if mesh is not None:
        from copilot_for_consensus_tpu_torch.models import decoder
        from copilot_for_consensus_tpu_torch.parallel.sharding import (
            serving_param_rules,
            shard_views,
        )

        if cfg is None:
            raise ValueError("params_from_numpy(mesh=...) needs the "
                             "decoder's cfg for its sharding rules")
        tree = shard_views(tree, decoder.param_logical_axes(cfg, tree),
                           mesh, serving_param_rules(cfg, mesh))

    def leaf(name: str, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            want = torch.int8 if name in _INT8_LEAVES else \
                torch.float32 if name == "scale" else \
                a.dtype if name in _KEEP_DTYPE else dtype
            return a.to(device).to(want).contiguous()
        a = np.asarray(a)
        if name in _KEEP_DTYPE:
            if a.dtype.name == "bfloat16":          # ml_dtypes, as words
                return torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16).to(device)
            return torch.from_numpy(np.array(a)).to(device)
        if name in _INT8_LEAVES:
            return torch.from_numpy(a.astype(np.int8)).to(device)
        if name == "scale":
            return torch.from_numpy(a.astype(np.float32)).to(device)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    def walk(node: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)
