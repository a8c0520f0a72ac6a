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


def storage_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for a one-byte float (the fp8 KV dtypes) its
    bytes as ``uint8``: PyTorch implements few indexing and selection ops
    (``index_put_``, ``torch.where``, ``fill_``) for float8 tensors, and
    moving bytes needs none of them. Writes through the view land in
    ``t``."""
    if t.is_floating_point() and t.element_size() == 1:
        return t.view(torch.uint8)
    return t


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros`` for every KV dtype: a one-byte float is made as
    zero bytes and viewed (0x00 is +0 in both fp8 formats)."""
    if dtype.is_floating_point and dtype.itemsize == 1:
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)
