"""One CUDA graph per decode bucket — the port's counterpart of the JAX
engine's ``jit`` caches (``_decode_fn`` per ``(kv_len, n_windows)`` for
the contiguous cache, ``_decode_paged_fn`` per table width for the paged
pool).

A decode dispatch launches ~50 kernels a layer a step from Python; the
card idles while the host issues them. The engine's dispatch body reads
only static buffers that live across dispatches (tokens, positions, block
tables, write maps, window buffers, the output tokens), so a capture of it
at one bucket can be replayed for every later dispatch at that bucket once
the host has copied the dispatch's values into those buffers.

:class:`DecodeGraphs` owns the graphs of one engine:

* the first dispatch of a family of keys (the engine's: one
  activation-quantization mode, which picks the kernels) runs the body
  eagerly — it is the dispatch itself and warms everything a capture
  cannot do (a kernel library's ``nvcc`` build, the stream bodies' lazily
  allocated split counters, the C entries' attribute calls), none of
  which depends on the bucket; so does the first dispatch in each thread
  that would capture, since cuBLAS creates a thread's handle at its first
  call and a handle cannot be created during a capture (an engine warmed
  by a synchronous ``generate`` and then driven by the async runner's
  thread would otherwise fail its first capture there); every later
  dispatch at a bucket without a
  graph captures the body and replays it at once, and every dispatch
  after that replays. A capture costs about what an eager dispatch costs
  on the host, so capturing right after the warm-up, or warming each
  bucket up eagerly before its capture, made short serves (an int4
  summary of 64 tokens meets a new bucket every few dispatches) slower
  than the eager engine;
* all graphs share one memory pool (only one replays at a time) and the
  engine's stream: warm-up, capture and replay run on it in order, so
  the split counters the stream bodies of K2, K5 and K6 share are never
  used by two launches at once, and cuBLAS sees the same workspace
  eagerly and under capture;
* the kernel wrappers' ``launches`` / ``launches_by_body`` counters tick
  while a body is captured, though nothing runs: each graph keeps the
  counters' delta of its capture, the capture's tick is taken back, and
  every replay adds the delta — the counts read as if each dispatch had
  launched its kernels from Python;
* a failure raises: nothing falls back to the eager body. The engine
  drops its graphs after a failed dispatch (:meth:`drop`) and, when a
  supervisor repairs its state, recaptures only after the repair
  (:meth:`release`).

On the CPU there is nothing to capture: :meth:`run` calls the body, so
the CPU tests run exactly the code the card captures.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Hashable

import torch


def _wrappers() -> tuple:
    """The kernel wrappers whose launch counters a decode body ticks."""
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    return (fa.flash_attention, qm.int8_matmul, pa.paged_attention_partial,
            qm.w8a8_matmul, qm.int4_matmul, qm.w4a8_matmul)


def _counts() -> list[tuple[int, dict]]:
    return [(fn.launches, dict(fn.launches_by_body)) for fn in _wrappers()]


def _delta(before, after) -> list[tuple[int, dict]]:
    return [(n1 - n0, {k: b1[k] - b0[k] for k in b1})
            for (n0, b0), (n1, b1) in zip(before, after)]


def _add(delta, sign: int) -> None:
    for fn, (n, by_body) in zip(_wrappers(), delta):
        fn.launches += sign * n
        for k, v in by_body.items():
            fn.launches_by_body[k] += sign * v


class DecodeGraphs:
    """The decode graphs of one engine, keyed by bucket.

    ``device``: the engine's device (graphs only on CUDA); ``enabled``:
    False runs the body eagerly on the card too (the engine's
    ``cuda_graphs=False``, for holding replays against the eager body);
    ``stream``: the engine's CUDA stream, on which the body is captured;
    ``generators``: the random generators the body draws from, registered
    with every graph so that replays advance them; ``eager_reason``: why
    graphs are off where the engine turned them off itself (a mesh whose
    collectives this build cannot capture), reported by :meth:`stats`."""

    def __init__(self, device: torch.device, *, enabled: bool = True,
                 stream: torch.cuda.Stream | None = None,
                 generators: tuple = (), eager_reason: str = ""):
        self.enabled = enabled and device.type == "cuda"
        self.eager_reason = eager_reason
        self._stream = stream
        self._generators = tuple(generators)
        self._graphs: dict[Hashable, tuple] = {}
        #: families whose eager warm-up has run; ``_tls.warm`` is set on a
        #: thread that ran one (a flag, not an ident: idents are reused)
        self._warm: set = set()
        self._tls = threading.local()
        self._pool = None
        #: set by :meth:`drop` when a supervisor will repair the engine:
        #: no capture or replay until :meth:`release`
        self.blocked = False
        #: graphs captured, seconds spent capturing them, replays, and
        #: dispatches that ran the body eagerly (warm-ups, the CPU)
        self.captured = 0
        self.capture_s = 0.0
        self.replays = 0
        self.eager = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key: Hashable) -> bool:
        """Whether a dispatch at bucket ``key`` would replay a graph."""
        return key in self._graphs

    def stats(self) -> dict:
        out = {"enabled": self.enabled, "graphs": len(self._graphs),
               "captured": self.captured, "capture_s": self.capture_s,
               "replays": self.replays, "eager": self.eager}
        if self.eager_reason:
            out["eager_reason"] = self.eager_reason
        return out

    def run(self, key: Hashable, body: Callable[[], None],
            family: Hashable = None) -> None:
        """One dispatch at bucket ``key`` (of ``family``): replay its
        graph; or capture ``body`` and replay it; or, the first time for
        ``family``, run ``body`` eagerly."""
        if not self.enabled:
            body()
            self.eager += 1
            return
        if self.blocked:
            raise RuntimeError(
                "decode graphs were dropped after a failed dispatch and the "
                "engine state has not been repaired yet")
        if key not in self._graphs and (
                family not in self._warm
                or not getattr(self._tls, "warm", False)):
            body()
            self.eager += 1
            self._warm.add(family)
            self._tls.warm = True
            return
        if key not in self._graphs:
            self._capture(key, body)
        graph, delta = self._graphs[key]
        graph.replay()
        _add(delta, +1)
        self.replays += 1

    def _capture(self, key: Hashable, body: Callable[[], None]) -> None:
        t0 = time.monotonic()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = _counts()
        try:
            # thread_local: another thread's CUDA calls (a submitter's
            # tokenization, a caller's allocation) cannot invalidate the
            # capture the engine's owner thread is making
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            # the capture launched nothing: take its counts back
            delta = _delta(before, _counts())
            _add(delta, -1)
        self._graphs[key] = (graph, delta)
        self.captured += 1
        self.capture_s += time.monotonic() - t0

    def drop(self, *, block: bool) -> None:
        """Forget every graph (after a failed dispatch). ``block``: refuse
        to capture or replay until :meth:`release` — the engine's
        supervisor repairs the state first. The families stay warm: what
        the warm-up does is done once for the process."""
        self._graphs.clear()
        self._pool = None
        self.blocked = block

    def release(self) -> None:
        """The engine state the graphs read was repaired: capturing may
        start again."""
        self.blocked = False
