"""Param trees from numpy: the bridge between the two packages' weights.

``params_from_numpy`` takes a decoder param tree whose leaves are numpy
arrays — the JAX package's tree after ``np.asarray`` on every leaf, int8
``{"q", "scale"}`` leaves included — and returns the port's tree on
``device``: int8 ``q`` stays int8, ``scale`` is f32, every other leaf is
cast to ``dtype``. Layouts are the same in both packages, so the same
weights drive both.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype


def params_from_numpy(tree: dict[str, Any], device, dtype) -> dict:
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def leaf(name: str, a) -> torch.Tensor:
        a = np.asarray(a)
        if name == "q":
            return torch.from_numpy(a.astype(np.int8)).to(device)
        if name == "scale":
            return torch.from_numpy(a.astype(np.float32)).to(device)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    def walk(node: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)
