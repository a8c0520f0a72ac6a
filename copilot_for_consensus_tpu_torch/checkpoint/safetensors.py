"""The safetensors file format, read and written with numpy and torch only.

A file is an 8-byte little-endian header length ``N``, then ``N`` bytes of
JSON, then the data. The header maps each tensor name to its ``dtype``,
``shape`` and ``data_offsets`` ([begin, end) in bytes from the start of
the data), and may hold a ``__metadata__`` map of strings.

This module stands in for the ``safetensors`` package and for
``ml_dtypes`` (which numpy needs for bfloat16), so that the port reads
and writes the repository's checkpoints on a machine with neither. It
covers the dtypes the repository writes: F32, F16, BF16, I8, U8, I32 and
I64.

Reading maps the file once (``np.memmap`` copy-on-write: pages are shared
with the page cache until written, and nothing is ever written back), and
each tensor is a CPU ``torch`` tensor over its bytes, so a leaf reaches
the card with one host-to-device copy and no second host copy. BF16 is
read as 16-bit words and viewed as ``torch.bfloat16``. A tensor whose
offset is not a multiple of its item size is copied, not viewed.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
from typing import Any, Mapping

import numpy as np
import torch

#: safetensors dtype tag → (numpy storage dtype, torch dtype)
_DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_TAGS = {tdt: tag for tag, (_, tdt) in _DTYPES.items()}
#: a header larger than this is a corrupt length, not a checkpoint
_MAX_HEADER = 100 << 20


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


class SafetensorsFile:
    """One mapped file: ``keys()``, ``get(name)`` and ``metadata``."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise SafetensorsError(f"{self.path}: shorter than 8 bytes")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise SafetensorsError(
                    f"{self.path}: header length {n} is not plausible")
            raw = f.read(n)
        if len(raw) != n:
            raise SafetensorsError(f"{self.path}: header cut short")
        try:
            header = json.loads(raw)
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise SafetensorsError(f"{self.path}: bad header: {exc}") \
                from None
        self.metadata: dict[str, str] | None = header.pop("__metadata__",
                                                          None)
        self._entries: dict[str, dict] = header
        self._base = 8 + n
        size = self.path.stat().st_size
        for name, e in header.items():
            tag = e.get("dtype")
            if tag not in _DTYPES:
                raise SafetensorsError(
                    f"{self.path}: tensor {name!r} has dtype {tag!r}; "
                    f"supported: {sorted(_DTYPES)}")
            begin, end = e["data_offsets"]
            want = int(np.prod(e["shape"], dtype=np.int64)) \
                * _DTYPES[tag][0].itemsize
            if end - begin != want or begin < 0 \
                    or self._base + end > size:
                raise SafetensorsError(
                    f"{self.path}: tensor {name!r} offsets {begin}..{end} "
                    f"do not hold {e['shape']} {tag}")
        # no mapping of a file without data bytes (numpy refuses one)
        self._map = np.memmap(self.path, dtype=np.uint8, mode="c") \
            if size > self._base else None

    def keys(self) -> list[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        np_dtype, torch_dtype = _DTYPES[e["dtype"]]
        begin, end = (self._base + o for o in e["data_offsets"])
        shape = tuple(e["shape"])
        if begin == end:
            return torch.empty(shape, dtype=torch_dtype)
        raw = self._map[begin:end]
        if begin % np_dtype.itemsize:
            # a view would be misaligned: copy the bytes out (an aligned,
            # writable array of its own)
            raw = np.array(raw)
        arr = raw.view(np_dtype)
        t = torch.from_numpy(arr.reshape(shape))
        return t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t


def load_file(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """Every tensor of the file, in header order, as CPU tensors over the
    mapped bytes."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str | pathlib.Path,
              metadata: Mapping[str, str] | None = None) -> int:
    """Write ``tensors`` (torch tensors on any device) to ``path``; returns
    the bytes written. Tensors go by item size, largest
    first, then by name, so every offset is a multiple of its item size;
    the header is padded with spaces to a multiple of 8. Device tensors
    are copied to the host one at a time. The file is written beside
    ``path`` and renamed over it."""
    ts = dict(tensors)
    for name, t in ts.items():
        if t.dtype not in _TAGS:
            raise SafetensorsError(f"tensor {name!r}: dtype {t.dtype} is "
                                   f"not supported")
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header: dict[str, Any] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = ts[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    # written beside and renamed over ``path``: a reader that has the old
    # file mapped keeps its inode (truncating it in place would fault
    # that reader's pages), and no reader sees half a file
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".partial")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = ts[name].detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            if t.numel():
                f.write(memoryview(t.reshape(-1).numpy()).cast("B"))
    os.replace(tmp, path)
    return 8 + len(raw) + offset
