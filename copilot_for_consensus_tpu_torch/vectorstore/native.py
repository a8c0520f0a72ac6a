"""Native host-side exact-search driver: C++ scoring/top-k via ctypes.

The first-party replacement for the FAISS role in the reference
(``faiss_store.py:18`` — a C++ flat index consumed as a library). The
store layer (ids, metadata, inverted-index filters, persistence) is
shared with :class:`InMemoryVectorStore`; only the hot loop — dot-product
scoring + top-k selection over the packed matrix — runs in C++
(``_native/topk.cpp``), compiled on first use with g++ into a cached
shared object. No compiler → transparent NumPy fallback, same results.

Use this driver for host-resident corpora when a TPU is absent or busy;
the ``tpu`` driver keeps the corpus in HBM and scores on-device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Any

import numpy as np

from copilot_for_consensus_tpu_torch.vectorstore.base import QueryResult
from copilot_for_consensus_tpu_torch.vectorstore.memory import InMemoryVectorStore

_SRC = pathlib.Path(__file__).resolve().parent / "_native" / "topk.cpp"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None | bool = None   # None = not tried, False = failed


# Module-level override for the compiled-object cache dir (tests, build
# farms); default is the system tempdir. Not config-driven: this is
# toolchain plumbing, and the no-runtime-env-vars policy
# (tests/test_no_runtime_env_vars.py) bans env reads here.
BUILD_CACHE_DIR: str | None = None


def _build_dir() -> pathlib.Path:
    return pathlib.Path(BUILD_CACHE_DIR or os.path.join(
        tempfile.gettempdir(), "copilot-native"))


def load_native_lib() -> ctypes.CDLL | None:
    """Compile (once, cached by source hash) and load the C++ core.
    Returns None when no toolchain is available."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        try:
            src = _SRC.read_bytes()
            tag = hashlib.sha256(src).hexdigest()[:16]
            out = _build_dir() / f"topk-{tag}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".build-{os.getpid()}.so")
                # NEVER -ffast-math here: it links crtfastmath.o into
                # the .so, and loading that flips FTZ/DAZ process-wide
                # (see topk.cpp header).
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC",
                     "-std=c++17", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)   # atomic vs concurrent builders
            lib = ctypes.CDLL(str(out))
            i64 = ctypes.c_int64
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(i64)
            lib.topk_dot.argtypes = [fp, i64, i64, fp, ip, i64, i64,
                                     ip, fp]
            lib.topk_dot.restype = None
            _LIB = lib
        except Exception:
            _LIB = False
        return _LIB or None


class NativeFlatVectorStore(InMemoryVectorStore):
    """InMemoryVectorStore with the scoring/top-k hot loop in C++."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        self._lib = load_native_lib()

    @property
    def native_available(self) -> bool:
        return self._lib is not None

    def _native_topk(self, q: np.ndarray, rows: np.ndarray | None,
                     k: int) -> tuple[np.ndarray, np.ndarray]:
        n = self._n
        vecs = np.ascontiguousarray(self._vectors[:n])
        q = np.ascontiguousarray(q, dtype=np.float32)
        total = n if rows is None else len(rows)
        k = min(k, total)
        out_idx = np.zeros(k, dtype=np.int64)
        out_score = np.zeros(k, dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int64)
        rows_ptr = (None if rows is None else
                    np.ascontiguousarray(rows, dtype=np.int64))
        self._lib.topk_dot(
            vecs.ctypes.data_as(fp), n, vecs.shape[1],
            q.ctypes.data_as(fp),
            rows_ptr.ctypes.data_as(ip) if rows_ptr is not None else None,
            0 if rows_ptr is None else len(rows_ptr),
            k, out_idx.ctypes.data_as(ip),
            out_score.ctypes.data_as(fp))
        return out_idx[:k], out_score[:k]

    def query(self, vector, top_k=10, flt=None):
        if self._lib is None:
            return super().query(vector, top_k, flt)
        with self._lock:
            if not self._ids:
                return []
            q = self._normalize(vector)
            rows = None
            if flt:
                cand = self._matching_rows(flt)
                if not cand:
                    return []
                rows = np.asarray(cand, dtype=np.int64)
            idx, scores = self._native_topk(q, rows, top_k)
            return [QueryResult(self._ids[i], float(s),
                                dict(self._metadata[i]))
                    for i, s in zip(idx, scores)]
