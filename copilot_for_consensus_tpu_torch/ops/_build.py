"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` run into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. The libraries land in
``build/cuda_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of their source so an edited kernel is rebuilt and an
unchanged one is reused. ``build_all`` starts every compile at once.

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
        # B, Hq, Hkv, Sq, Skv, D, causal, window, is_bf16, stream
        "flash_attention_fwd": [_P] * 7 + [_I] * 9 + [_P],
    },
    "int8_matmul": {
        # x, q, scale, out, workspace, M, D, F, splits, is_bf16, stream
        "int8_matmul_fwd": [_P] * 5 + [_I] * 5 + [_P],
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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
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
