# The port's async dispatcher front end (engine/async_runner.py) over the
# port's engine on the CPU, tiny f32: the seven cases of
# tests/test_engine_async.py — thread-safe submits, results equal to the
# synchronous engine's, liveness under staggered arrivals, prompt
# failure of outstanding handles on stop, contained bad requests, done
# callbacks — plus async token streams equal to the JAX engine's.
import threading
import time

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
from copilot_for_consensus_tpu_torch.engine.async_runner import (
    AsyncEngineRunner,
    Handle,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    Completion,
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

CFG = decoder_config("tiny")
JP = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                      dtype=jnp.float32)
TREE = jax.tree.map(np.asarray, JP)
KW = dict(num_slots=4, max_len=64, prefill_buckets=(16,), decode_window=4)
PROMPTS = [[5, 9, 13], [7, 8, 9, 10], [3, 4], [40, 41, 42]]


def _engine(**kw):
    return GenerationEngine(CFG, params_from_numpy(TREE, "cpu", "float32"),
                            dtype="float32", device="cpu", **{**KW, **kw})


def test_async_matches_sync_results():
    sync = {tuple(p): c.tokens
            for p, c in zip(PROMPTS,
                            _engine().generate(PROMPTS, max_new_tokens=6))}
    runner = AsyncEngineRunner(_engine()).start()
    try:
        handles = [(p, runner.submit(list(p), 6)) for p in PROMPTS]
        for p, h in handles:
            assert h.result(timeout=120).tokens == sync[tuple(p)]
    finally:
        runner.stop()


@pytest.mark.parametrize("quantize", [False, "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_async_streams_equal_sync_port_and_jax_engines(quantize, paged):
    """The runner's streams against the synchronous port engine's and the
    JAX engine's on the same weights: all submitted before the dispatcher
    admits them, so the three admit the same waves."""
    kw = dict(num_slots=4, max_len=128, prefill_buckets=(32,),
              decode_window=4, windows_per_dispatch=2, prefill_chunk=32,
              kv_pool_blocks=20 if paged else 0, quantize=quantize)
    jeng = JaxEngine(jax_config("tiny"), JP, dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla", telemetry=False,
                     kv_kernel="pallas" if paged else "auto", **kw)
    want = [c.tokens for c in jeng.generate(PROMPTS, max_new_tokens=9)]
    sync = [c.tokens for c in _engine(**kw).generate(PROMPTS,
                                                     max_new_tokens=9)]
    eng = _engine(**kw)
    # admission closed (an occupancy cap of 0) until every request has
    # reached the engine's queue: one wave, as generate() admits it
    eng._slot_cap = 0
    runner = AsyncEngineRunner(eng, supervisor=True).start()
    handles = [runner.submit(list(p), 9) for p in PROMPTS]
    deadline = time.monotonic() + 60
    while len(eng._queue) < len(PROMPTS) and time.monotonic() < deadline:
        time.sleep(0.01)
    eng.set_slot_cap(eng.num_slots)
    got = [h.result(timeout=120).tokens for h in handles]
    assert runner.stop() is True
    assert got == sync == want
    assert runner.recovery_stats()["containments"] == 0


def test_async_concurrent_submitters_and_stragglers():
    """Submits from many threads, arriving while earlier requests are
    mid-decode, all complete; more requests than slots queue cleanly."""
    runner = AsyncEngineRunner(_engine(num_slots=2)).start()
    results = {}
    lock = threading.Lock()

    def client(i):
        h = runner.submit([3 + i, 4 + i, 5 + i], 5)
        c = h.result(timeout=120)
        with lock:
            results[i] = c

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 7
        assert runner.completed == 7
        for i, c in results.items():
            assert c.prompt_len == 3 and 1 <= len(c.tokens) <= 5
    finally:
        runner.stop()


def test_async_submit_before_start_raises():
    runner = AsyncEngineRunner(_engine())
    with pytest.raises(RuntimeError):
        runner.submit([1, 2, 3], 4)


def test_async_stop_fails_outstanding_handles_promptly():
    """stop() must resolve blocked callers with RuntimeError instead of
    leaving them to sit out their full result() timeout."""

    class _StubEngine:
        """Never completes anything; step() blocks until released."""

        def __init__(self):
            self._active = {}
            self._queue = []
            self.release = threading.Event()
            self._rid = 0

        def submit(self, prompt, max_new_tokens):
            self._rid += 1
            self._queue.append(self._rid)
            return self._rid

        def step(self):
            self.release.wait(10)
            return []

    eng = _StubEngine()
    runner = AsyncEngineRunner(eng).start()
    h = runner.submit([1, 2, 3], 4)
    errs = []

    def waiter():
        try:
            h.result(timeout=60)
        except BaseException as exc:   # noqa: BLE001 — record whatever
            errs.append(exc)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)                    # let the dispatcher enter step()
    t0 = time.monotonic()
    eng.release.set()
    runner.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 10        # promptly, not the full 60s
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)
    assert "runner stopped" in str(errs[0])


def test_async_bad_request_fails_its_handle_not_the_loop():
    """An invalid submit (empty prompt) must error THAT handle while the
    dispatcher keeps serving everyone else."""
    runner = AsyncEngineRunner(_engine()).start()
    try:
        bad = runner.submit([], 4)
        good = runner.submit([5, 6, 7], 4)
        with pytest.raises(ValueError, match="empty prompt"):
            bad.result(timeout=60)
        assert len(good.result(timeout=120).tokens) >= 1
    finally:
        runner.stop()


def test_done_callbacks_fire_without_polling():
    """Callbacks fire on resolution (dispatcher thread), fire immediately
    when registered after resolution, and fire on failure too — no caller
    ever needs to poll done()."""
    runner = AsyncEngineRunner(_engine()).start()
    try:
        fired = []
        ev = threading.Event()
        h = runner.submit([5, 6, 7], 4)
        h.add_done_callback(lambda hh: (fired.append(hh.request_id),
                                        ev.set()))
        assert ev.wait(120)
        assert fired == [h.request_id]
        assert h.done() and h.result(0).tokens
        # late registration: fires immediately on the calling thread
        late = []
        h.add_done_callback(lambda hh: late.append("now"))
        assert late == ["now"]
        # failure path: bad request resolves its handle via callback
        fail_ev = threading.Event()
        bad = runner.submit([], 4)
        bad.add_done_callback(lambda hh: fail_ev.set())
        assert fail_ev.wait(30)
        with pytest.raises(Exception):
            bad.result(0)
        # a raising callback must not kill the dispatcher
        h2 = runner.submit([9, 9], 4)
        h2.add_done_callback(lambda hh: 1 / 0)
        assert h2.result(120).tokens
        h3 = runner.submit([4, 5], 4)
        assert h3.result(120).tokens       # dispatcher still alive
    finally:
        runner.stop()


def test_immediate_fire_callback_errors_are_contained():
    """A raising observer registered AFTER resolution must be contained
    as one registered before resolution is: whether the error escapes
    must not depend on the registration/resolution race."""
    h = Handle()
    h.request_id = 1
    h._resolve(Completion(request_id=1, prompt_len=3, tokens=[4],
                          finish_reason="length"))
    fired = []
    # already resolved → fires immediately — and must NOT raise
    h.add_done_callback(lambda hh: (fired.append(hh.request_id),
                                    1 / 0))
    assert fired == [1]
    # same containment on the failure-resolved path
    h2 = Handle()
    h2._fail(RuntimeError("boom"))
    h2.add_done_callback(lambda hh: 1 / 0)   # must not raise either


def test_replayed_request_continues_bit_identically():
    """A decode dispatch that fails once (an injected fault): the
    supervisor evacuates the slot and the runner resubmits prompt +
    accepted tokens; greedy f32 continues the stream exactly."""
    from copilot_for_consensus_tpu_torch.engine.faults import FaultSpec

    want = _engine().generate([[5, 9, 13]], max_new_tokens=12)[0].tokens
    eng = _engine(faults=[FaultSpec(kind="decode", at=2, count=1)])
    runner = AsyncEngineRunner(eng, supervisor=True).start()
    try:
        c = runner.submit([5, 9, 13], 12, correlation_id="r").result(120)
        assert c.tokens == want and c.prompt_len == 3
        assert runner.replayed == 1 and runner.recovered == 1
        assert runner.recovery_stats()["containments"] == 1
    finally:
        runner.stop()


def _threads():
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )

    return [ThreadContext(thread_id=f"t{i}", subject=f"Topic {i}",
                          participants=["alice@example.org"],
                          message_count=2 + i,
                          chunks=[{"chunk_id": f"c{i}",
                                   "text": f"Point {i}: ship it."}])
            for i in range(4)]


def test_summarize_async_equals_summarize_batch():
    """CUDASummarizer.summarize_async from two submitting threads, through
    the runner and its supervisor, gives summarize_batch's summaries (one
    admission wave for both: admission opens once all four are queued);
    summarize_batch afterwards goes through the runner; drain and close
    stop it."""
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    kw = dict(num_slots=4, max_len=256, prefill_buckets=(128,),
              decode_window=4)
    threads = _threads()
    want = CUDASummarizer("tiny", engine=_engine(**kw), max_new_tokens=8) \
        .summarize_batch(threads)
    eng = _engine(**kw)
    summ = CUDASummarizer("tiny", engine=eng, max_new_tokens=8,
                          supervisor=True)
    eng._slot_cap = 0
    waits = [None] * len(threads)

    def submit(idx):
        for i in idx:
            waits[i] = summ.summarize_async(threads[i],
                                            correlation_id=f"e{i}")

    subs = [threading.Thread(target=submit, args=(idx,))
            for idx in ((0, 2), (1, 3))]
    for t in subs:
        t.start()
    for t in subs:
        t.join(60)
    deadline = time.monotonic() + 60
    while len(eng._queue) < len(threads) and time.monotonic() < deadline:
        time.sleep(0.01)
    eng.set_slot_cap(eng.num_slots)
    got = [w(120) for w in waits]
    assert [g.summary_text for g in got] == [w.summary_text for w in want]
    assert [g.completion_tokens for g in got] == \
        [w.completion_tokens for w in want]
    runner = summ._runner
    assert runner is not None and runner.supervisor is not None
    again = summ.summarize_batch(threads[:2])      # through the runner
    assert [a.thread_id for a in again] == ["t0", "t1"]
    assert runner.completed == 6
    assert summ.drain(30) is True and summ._runner is None
    summ.close()                                   # nothing left to stop


def test_port_logger_writes_one_json_line():
    """The runner reports a dispatcher that failed to join through the
    port's default logger: one JSON object a line with the call's
    fields, and records under the logger's level dropped."""
    import io
    import json

    from copilot_for_consensus_tpu_torch.obs import logging as obs_logging

    out = io.StringIO()
    log = obs_logging.StdoutLogger(service="engine", level="info",
                                   stream=out)
    before = obs_logging.get_logger()
    obs_logging.set_default_logger(log)
    try:
        obs_logging.get_logger().error(
            "engine dispatcher failed to join on stop", correlation_id="c1",
            timeout_s=5.0)
        obs_logging.get_logger().debug("dropped")
    finally:
        obs_logging.set_default_logger(before)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["level"] == "error" and rec["service"] == "engine"
    assert rec["correlation_id"] == "c1" and rec["timeout_s"] == 5.0
    assert rec["message"] == "engine dispatcher failed to join on stop"
