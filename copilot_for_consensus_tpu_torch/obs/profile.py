"""torch.profiler integration: flag-gated trace capture on the engines.

The port of the JAX package's ``obs/profile.py``, on ``torch.profiler``
instead of ``jax.profiler``. Usage:

    with maybe_profile("var/traces"):            # or None → no-op
        engine.generate(...)

A trace is a Chrome / Perfetto JSON file written into the directory when
the context exits (``trace-<pid>-<n>.json``, one a capture). Enable it on
the serving engines with ``profile_dir=`` (``GenerationEngine``,
``LongContextEngine``, ``CUDASummarizer``, config ``llm.profile_dir``);
the flag defaults off, so production pays nothing for it.

``step_annotation`` wraps each engine dispatch in a
``torch.profiler.record_function`` named ``"<kind>:<step>"``, where the
step is the flight recorder's step id (``engine/telemetry.py``): a trace
row and a host-side ``StepRecord`` then name the same dispatch. On the
card it is also an NVTX range of that name, which an external CUDA
profiler shows on its timeline. Outside a profiling session both cost a
few microseconds, so the engines keep them on.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib

import torch

_captures = itertools.count()


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Capture a ``torch.profiler`` trace into ``trace_dir`` when it is set
    (the card's activity too where a card is available); a plain no-op when
    it is None or empty, so callers never branch. Yields the trace file's
    path, or None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = path / f"trace-{os.getpid()}-{next(_captures)}.json"
    with profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out))


@contextlib.contextmanager
def step_annotation(name: str, step_num: int | None = None,
                    device: torch.device | None = None):
    """One engine dispatch as a profiler range named ``name`` (the wave
    kind: prefill / decode / verify / ...) and ``step_num`` (the flight
    recorder's step id), and as an NVTX range when ``device`` is a CUDA
    device."""
    label = name if step_num is None else f"{name}:{step_num}"
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
