# The admission holds (admit_min_rows, admit_max_wait_s, admit_hold_strict)
# on the port's engine against the JAX package's, on the same weights in
# float32: both engines, driven step by step through the same arrivals
# (one a step), hold and release the same requests in the same waves —
# with the wait bound at 0 (never hold) and at 1e9 (hold until the rows
# come), strict and loose, over an idle and over a busy batch — and their
# greedy streams agree.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

CFG = decoder_config("tiny")
KW = dict(num_slots=8, max_len=128, prefill_buckets=(16, 32),
          decode_window=4, admit_min_rows=4)


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(**kw):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", device="cpu",
                            **{**KW, "telemetry": False, **kw})


def _jax(**kw):
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     **{**KW, "telemetry": False, **kw})


def _prompt(i):
    return np.random.default_rng(100 + i).integers(
        3, CFG.vocab_size, size=6 + i % 5).tolist()


def _drive(eng, busy: int, steps: int = 16):
    """``busy`` long requests first, then one arrival a step for 8 steps;
    after every step, the admitted request ids, the queue length and the
    streams finished so far."""
    for i in range(busy):
        eng.submit(_prompt(50 + i), max_new_tokens=60)
    trace, streams = [], {}
    for t in range(steps):
        if t < 8:
            eng.submit(_prompt(t), max_new_tokens=6)
        for c in eng.step():
            streams[c.request_id] = c.tokens
        trace.append((tuple(sorted(r.request_id
                                   for r in eng._active.values())),
                      len(eng._queue)))
    return trace, streams


def _waves(trace):
    """Sizes of the admissions the trace shows (newly active ids a step,
    retired ones aside)."""
    seen, waves = set(), []
    for active, _q in trace:
        new = set(active) - seen
        if new:
            waves.append(len(new))
        seen |= set(active)
    return waves


@pytest.mark.parametrize("busy", [0, 6], ids=["idle", "busy"])
@pytest.mark.parametrize("strict", [False, True], ids=["loose", "strict"])
@pytest.mark.parametrize("wait", [0.0, 1e9], ids=["wait0", "wait1e9"])
def test_holds_admit_the_same_waves_as_jax(wait, strict, busy):
    kw = dict(admit_max_wait_s=wait, admit_hold_strict=strict)
    got, got_streams = _drive(_port(**kw), busy)
    want, want_streams = _drive(_jax(**kw), busy)
    assert got == want
    assert got_streams == want_streams
    waves = _waves(got)
    if wait == 0.0 or (not strict and not busy):
        # no hold: every arrival is admitted in the step it arrives
        assert all(n == 1 for n in waves[1 if busy else 0:])
    elif strict and not busy:
        # strict: the arrivals wait until four are queued
        assert waves[:2] == [4, 4]
    else:
        # a busy batch holds: the next wave waits for the queue to fill
        assert max(waves[1:]) > 1


def test_hold_defaults_are_the_reference_defaults():
    eng = _port(admit_min_rows=1)
    jeng = _jax(admit_min_rows=1)
    for name in ("admit_max_wait_s", "admit_hold_strict"):
        assert getattr(GenerationEngine(
            CFG, params_from_numpy(_weights()[1], "cpu", "float32"),
            dtype="float32", device="cpu", telemetry=False), name) == \
            getattr(JaxEngine(jax_config("tiny"), _weights()[0],
                              dtype=jnp.float32, telemetry=False), name)
    assert eng.admit_min_rows == jeng.admit_min_rows == 1
    assert _port(admit_min_rows=0).admit_min_rows == 1     # clamped


def test_the_wait_bound_releases_a_held_wave():
    eng = _port(admit_max_wait_s=5.0, admit_hold_strict=True)
    eng.submit(_prompt(0), max_new_tokens=40)
    eng.step()
    assert not eng._active and len(eng._queue) == 1      # held
    eng._queue[0].submitted_at -= 10.0                   # waited past it
    eng.step()
    assert len(eng._active) == 1 and not eng._queue
