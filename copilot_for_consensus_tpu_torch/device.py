"""Device and dtype resolution for the port's entry points.

``None`` means the card: the port serves on CUDA and never carries on
silently on the CPU. The CPU is reached only by asking for it
(``device="cpu"``), which is what the parity tests do.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raises when the requested CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "device='cpu' is passed explicitly")
    return dev


def resolve_dtype(dtype: str | torch.dtype | None,
                  default: torch.dtype = torch.bfloat16) -> torch.dtype:
    """Activation dtype from a torch dtype or its name ("bfloat16",
    "float32"); ``None`` gives ``default``."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype!r}; one of {sorted(_DTYPES)}") from None
