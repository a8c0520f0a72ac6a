"""Param trees from numpy: the bridge between the two packages' weights.

``params_from_numpy`` takes a decoder param tree whose leaves are numpy
arrays — the JAX package's tree after ``np.asarray`` on every leaf,
quantized leaves included (int8 ``{"q", "scale"}``, packed int4
``{"q4", "scale"}``) — or CPU torch tensors (a checkpoint read by
``checkpoint/native.py``), and returns the port's tree on ``device``: the
int8 bytes of ``q`` and ``q4`` stay int8, ``scale`` is f32, every other
leaf is cast to ``dtype``. Layouts are the same in both packages, so the
same weights drive both. A torch leaf moves to the device before it is
cast, so a leaf mapped from a file reaches the card with one copy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype


#: leaves that hold int8 bytes: cast to the activation dtype, packed
#: nibbles would be destroyed
_INT8_LEAVES = ("q", "q4")


def params_from_numpy(tree: dict[str, Any], device, dtype) -> dict:
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def leaf(name: str, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            want = torch.int8 if name in _INT8_LEAVES else \
                torch.float32 if name == "scale" else dtype
            return a.to(device).to(want)
        a = np.asarray(a)
        if name in _INT8_LEAVES:
            return torch.from_numpy(a.astype(np.int8)).to(device)
        if name == "scale":
            return torch.from_numpy(a.astype(np.float32)).to(device)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    def walk(node: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)
