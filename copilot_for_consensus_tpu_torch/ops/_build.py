"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` run into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. The libraries land in
``build/cuda_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of their source and the shared headers (``csrc/*.cuh``)
so an edited kernel is rebuilt and an unchanged one is reused. ``build_all`` starts every compile at once.

Nothing here runs at import: the first launch of a kernel builds it. A
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "cuda_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v", ARCH)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points and their argument types, per source. Pointers and the
#: stream are ``c_void_p`` (a bare Python int would be cut to 32 bits).
SIGNATURES: dict[str, dict[str, list]] = {
    "flash_attention": {
        # q, k, v, out, kv_lengths, q_offsets, kv_begins,
        # B, Hq, Hkv, Sq, Skv, D, causal, window, stream (the CUDA-core
        # body, f32)
        "flash_attention_fwd": [_P] * 7 + [_I] * 8 + [_P],
        # the same arguments (the wgmma body, bf16 at D 64 and 128)
        "flash_attention_wgmma_fwd": [_P] * 7 + [_I] * 8 + [_P],
        # head dim -> the wgmma body's dynamic shared memory in bytes
        "flash_attention_wgmma_smem": [_I],
        # the same arguments (the d32 body, bf16 at D 32)
        "flash_attention_d32_fwd": [_P] * 7 + [_I] * 8 + [_P],
        # the d32 body's dynamic shared memory in bytes
        "flash_attention_d32_smem": [],
    },
    "int8_matmul": {
        # x, q, scale, out, workspace, M, D, F, splits, is_bf16, stream
        "int8_matmul_fwd": [_P] * 5 + [_I] * 5 + [_P],
        # x, q, scale, out, M, D, F, tn, stream (the wgmma body, bf16 x)
        "int8_matmul_wgmma_fwd": [_P] * 4 + [_I] * 4 + [_P],
        # tile width -> the wgmma body's dynamic shared memory in bytes
        "int8_matmul_wgmma_smem": [_I],
        # x, q, scale, out, workspace, counters, M, D, F, tn, splits, rows,
        # stream (the stream body, bf16 x, M <= 8)
        "int8_matmul_stream_fwd": [_P] * 6 + [_I] * 6 + [_P],
        # the stream body's dynamic shared memory in bytes
        "int8_matmul_stream_smem": [],
    },
    "int4_matmul": {
        # x, q4, scale, out, workspace, M, D, F, G, splits, is_bf16, stream
        "int4_matmul_fwd": [_P] * 5 + [_I] * 6 + [_P],
        # x, q4, scale, out, M, D, F, G, stream (the wgmma body, bf16 x)
        "int4_matmul_wgmma_fwd": [_P] * 4 + [_I] * 4 + [_P],
        # the wgmma body's dynamic shared memory in bytes
        "int4_matmul_wgmma_smem": [],
        # x, q4, scale, out, workspace, counters, M, D, F, G, tn, splits,
        # per, stream (the stream body, bf16 x, M <= 32)
        "int4_matmul_stream_fwd": [_P] * 6 + [_I] * 7 + [_P],
        # token tiles (1-4) -> the stream body's dynamic shared memory
        "int4_matmul_stream_smem": [_I],
    },
    "w8a8_matmul": {
        # x, q, scale, out, xq, sx, M, D, F, is_bf16, stream (the mma.sync
        # tiling)
        "w8a8_matmul_fwd": [_P] * 6 + [_I] * 4 + [_P],
        # the same arguments (the wgmma body, D % 128, F % 16)
        "w8a8_matmul_wgmma_fwd": [_P] * 6 + [_I] * 4 + [_P],
        # the wgmma body's dynamic shared memory in bytes
        "w8a8_matmul_wgmma_smem": [],
    },
    "w4a8_matmul": {
        # x, q4, scale, out, xq, sx, workspace, M, D, F, G, splits, is_bf16,
        # stream
        "w4a8_matmul_fwd": [_P] * 7 + [_I] * 6 + [_P],
        # x, q4, scale, out, xq, sx, M, D, F, G, is_bf16, stream (the wgmma
        # body, M > 32)
        "w4a8_matmul_wgmma_fwd": [_P] * 6 + [_I] * 5 + [_P],
        # the wgmma body's dynamic shared memory in bytes
        "w4a8_matmul_wgmma_smem": [],
        # x, q4, scale, out, xq, sx, workspace, counters, M, D, F, G, tn,
        # splits, per, is_bf16, stream (the stream body, M <= 32)
        "w4a8_matmul_stream_fwd": [_P] * 8 + [_I] * 8 + [_P],
        # token tiles (1-4) -> the stream body's dynamic shared memory
        "w4a8_matmul_stream_smem": [_I],
    },
    "paged_attention": {
        # q_rows, pool_k, pool_v, tables, lengths, q_pos, acc, m, l,
        # B, Hkv, R, D, L, NBtot, blk, NB, li, window, q_bf16, kv_kind,
        # stream
        "paged_attention_fwd": [_P] * 9 + [_I] * 12 + [_P],
        # the split-KV decode body: the above without the dtypes, plus the
        # splits' scratch part_acc, part_ml after l, and split_len, NS
        # after window
        "paged_attention_decode_fwd": [_P] * 11 + [_I] * 12 + [_P],
        # the wgmma seeded body: the above without the dtypes
        "paged_attention_seeded_fwd": [_P] * 9 + [_I] * 10 + [_P],
        # head dim -> the seeded body's dynamic shared memory in bytes
        "paged_attention_seeded_smem": [_I],
    },
    "probe_stream": {
        # mode, x, w, out, workspace, B, D, F, bd, gdp, groups, stream
        "probe_stream_fwd": [_I] + [_P] * 4 + [_I] * 6 + [_P],
        # mode, x, w, out, xq (int8 x scratch; None for convdot), B, D, F,
        # bd, gdp, groups, stream (the wgmma body, modes 1-4)
        "probe_stream_wgmma_fwd": [_I] + [_P] * 4 + [_I] * 6 + [_P],
        # mode (1-4) -> the wgmma body's dynamic shared memory in bytes
        "probe_stream_wgmma_smem": [_I],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds, library path, compiler output
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on the machine "
            "with the card, from the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    # the source and every shared header it may include
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    # every source exports ``<name>_error``: cudaGetErrorString
    err = getattr(lib, f"{name}_error")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Compile every named source not yet built (one ``nvcc`` each, all
    started together) and load the libraries. Raises on any failure."""
    names = list(SIGNATURES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        t0 = time.monotonic()
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(".tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            build_log[n] = {"seconds": time.monotonic() - t0,
                            "library": str(out), "nvcc": text}
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n"
                              f"{text}")
            else:
                tmp.replace(out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for n in todo:
            _libs[n] = _load(n, _target(n))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]


def check(name: str, err: int, what: str) -> None:
    """Raise when an entry point of library ``name`` returned a CUDA
    error code (the launch was refused or failed)."""
    if err != 0:
        msg = getattr(_libs[name], f"{name}_error")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
