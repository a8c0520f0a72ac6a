# The scheduler and chunked prefill on the port's engine against the JAX
# package's, on the same weights in float32: greedy streams with chunked
# prefill equal monolithic admission and the JAX chunked engine's, on the
# contiguous cache and on the paged pool (K3's plain version here); chunks
# interleave with decode without perturbing it; ``submit`` sheds with the
# structured EngineOverloaded and the async runner passes a shed on with no
# error report; ``sched_stats()`` and the order of completions equal the
# JAX engine's on one scripted two-tenant run; deadlines drop a chunking
# row and a scheduler-queued request; a warm restart bypasses the shed
# gate; the supervisor's purge repays the scheduler's ledgers.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.scheduler import (
    SchedulerConfig as JaxSchedulerConfig,
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
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.journal import EngineJournal
from copilot_for_consensus_tpu_torch.engine.scheduler import (
    EngineOverloaded,
    Scheduler,
    SchedulerConfig,
)
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    EngineSupervisor,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.obs.errors import (
    CollectingErrorReporter,
)

CFG = decoder_config("tiny")
KW = dict(num_slots=4, max_len=256, prefill_buckets=(64, 128, 192),
          decode_window=4, prefill_chunk=64)


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port(paged_blocks=0, **kw):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", kv_pool_blocks=paged_blocks,
                            device="cpu", **{**KW, "telemetry": False, **kw})


def _jax(paged_blocks=0, **kw):
    return JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     kv_pool_blocks=paged_blocks,
                     kv_kernel="pallas" if paged_blocks else "auto",
                     **{**KW, "telemetry": False, **kw})


def _prompts(seed=5, lens=(180, 40, 150, 70, 100)):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.vocab_size, size=n).tolist() for n in lens]


def _drive(eng, n: int, limit: int = 400) -> list:
    """Step until ``n`` completions; returns them in completion order."""
    done = []
    for _ in range(limit):
        done += eng.step()
        if len(done) >= n:
            break
    assert len(done) == n
    return done


# ---------------------------------------------------------------------------
# chunked prefill: exactness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_chunked_runs():
    """The JAX chunked engines' streams and chunk counts, contiguous and
    paged (the Pallas kernel in interpret mode): built once."""
    out = {}
    for paged in (0, 16):
        eng = _jax(paged, scheduler=JaxSchedulerConfig(chunk_tokens=64))
        comps = eng.generate(_prompts(), max_new_tokens=8)
        out[paged] = ([c.tokens for c in comps], eng.sched_stats())
    return out


@pytest.mark.parametrize("paged", [0, 16], ids=["contiguous", "paged"])
def test_chunked_prefill_equals_monolithic_and_jax(jax_chunked_runs, paged):
    want, want_stats = jax_chunked_runs[paged]
    mono = [c.tokens for c in _port(paged).generate(_prompts(),
                                                    max_new_tokens=8)]
    eng = _port(paged, scheduler=SchedulerConfig(chunk_tokens=64))
    got = [c.tokens for c in eng.generate(_prompts(), max_new_tokens=8)]
    assert got == mono
    assert got == want
    stats = eng.sched_stats()
    assert stats["chunk_dispatches"] > 0
    assert stats == want_stats
    assert stats["chunk_prefill_tokens"] == 180 + 150 + 70 + 100
    if paged:
        st = eng.kv_pool_stats()
        assert st["free_blocks"] == st["num_blocks"]


def test_chunked_prefill_on_int8_weights_equals_monolithic():
    prompts = _prompts(seed=6)
    mono = [c.tokens for c in _port(quantize="int8").generate(
        prompts, max_new_tokens=6)]
    eng = _port(quantize="int8",
                scheduler=SchedulerConfig(chunk_tokens=32,
                                          prefill_wave_tokens=128))
    assert [c.tokens for c in eng.generate(prompts,
                                           max_new_tokens=6)] == mono
    assert eng.chunk_dispatches > 0


@pytest.mark.parametrize("paged", [0, 16], ids=["contiguous", "paged"])
def test_chunks_interleave_with_decode(paged):
    """A long prompt joining mid-decode must not perturb the stream
    already decoding (chunk dispatches park the decoding rows), and its
    own output must match the solo run."""
    rng = np.random.default_rng(5)
    short = rng.integers(3, CFG.vocab_size, size=12).tolist()
    long_p = rng.integers(3, CFG.vocab_size, size=150).tolist()
    solo = _port(paged).generate([short, long_p], max_new_tokens=30)
    eng = _port(paged, scheduler=SchedulerConfig(chunk_tokens=32))
    done = {}
    rid1 = eng.submit(short, 30)
    for _ in range(2):
        done.update({c.request_id: c for c in eng.step()})
    rid2 = eng.submit(long_p, 30, tenant="late", priority="batch")
    decoding_while_chunking = 0
    for _ in range(100):
        if eng._chunking and eng._active:
            decoding_while_chunking += 1
        done.update({c.request_id: c for c in eng.step()})
        if len(done) == 2:
            break
    assert done[rid1].tokens == solo[0].tokens
    assert done[rid2].tokens == solo[1].tokens
    assert decoding_while_chunking > 0
    assert eng.chunk_dispatches >= 150 // 32


# ---------------------------------------------------------------------------
# shedding
# ---------------------------------------------------------------------------


def test_submit_sheds_with_structured_rejection():
    """A submit storm against a small queue cap sheds at the door with
    EngineOverloaded; the queue never passes twice the cap; what was
    admitted completes."""
    rng = np.random.default_rng(7)
    eng = _port(scheduler=SchedulerConfig(max_queue_depth=6,
                                          batch_shed_depth=4))
    admitted, shed = [], 0
    for i in range(24):
        p = rng.integers(3, CFG.vocab_size, size=10).tolist()
        try:
            admitted.append(eng.submit(p, 3, tenant=f"t{i % 2}"))
        except EngineOverloaded as exc:
            shed += 1
            assert exc.retry_after_s >= 1.0
            assert exc.tenant == f"t{i % 2}"
        assert eng.queue_depth <= 12
    assert shed > 0 and admitted
    done = {c.request_id for c in _drive(eng, len(admitted))}
    assert done == set(admitted)
    stats = eng.sched_stats()
    assert stats["shed"] == shed
    assert 0.0 < stats["shed_rate"] < 1.0


def test_async_runner_passes_a_shed_on_without_an_error_report():
    """A shed is an admission outcome: the runner surfaces it to the
    caller (at submit or on the handle) and reports no engine failure."""
    eng = _port(telemetry=True,
                scheduler=SchedulerConfig(max_queue_depth=2,
                                          batch_shed_depth=1))
    rep = CollectingErrorReporter()
    runner = AsyncEngineRunner(eng, error_reporter=rep).start()
    try:
        handles, shed = [], 0
        for _ in range(16):
            try:
                handles.append(runner.submit([5, 6, 7, 8], 48))
            except EngineOverloaded:
                shed += 1
        ok = 0
        for h in handles:
            try:
                assert h.result(timeout=120.0).tokens
                ok += 1
            except EngineOverloaded as exc:
                shed += 1
                assert exc.retry_after_s >= 1.0
        assert shed > 0, "burst never shed"
        assert ok > 0, "nothing completed"
    finally:
        runner.stop()
    assert rep.reports == []
    assert eng.telemetry.errors == 0


# ---------------------------------------------------------------------------
# the scripted two-tenant run against the JAX engine
# ---------------------------------------------------------------------------


def _two_tenant(eng, sched_cfg_cls):
    """Long batch prompts of one tenant first, then short chat prompts of
    another, two a step: the JAX bench's mixed-traffic shape, small."""
    rng = np.random.default_rng(9)
    longs = [rng.integers(3, CFG.vocab_size, size=140).tolist()
             for _ in range(3)]
    chats = [rng.integers(3, CFG.vocab_size, size=20).tolist()
             for _ in range(6)]
    order, shed = [], 0
    script = [(0, p, "analytics", "batch") for p in longs] + \
        [(1 + i // 2, p, "chat", "interactive") for i, p in enumerate(chats)]
    names = {}
    for step in range(200):
        for s, p, tenant, prio in [x for x in script if x[0] == step]:
            try:
                rid = eng.submit(p, 6, tenant=tenant, priority=prio)
                names[rid] = (tenant, len(p))
            except EngineOverloaded:
                shed += 1
        order += [(names[c.request_id], c.tokens) for c in eng.step()]
        if len(order) + shed == len(script):
            break
    return order, shed, eng.sched_stats()


def test_sched_stats_and_completion_order_equal_jax():
    kw = dict(chunk_tokens=32, prefill_wave_tokens=96, quantum_tokens=32,
              tenant_weights={"chat": 2.0, "analytics": 1.0},
              max_queue_depth=8, batch_shed_depth=6)
    want = _two_tenant(_jax(scheduler=JaxSchedulerConfig(**kw)),
                       JaxSchedulerConfig)
    got = _two_tenant(_port(scheduler=SchedulerConfig(**kw)),
                      SchedulerConfig)
    assert got[0] == want[0]                   # order and streams
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[2]["chunk_dispatches"] > 0
    assert set(got[2]["fairness"]) == {"chat", "analytics"}


# ---------------------------------------------------------------------------
# deadlines, warm restart, purge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [0, 16], ids=["contiguous", "paged"])
def test_deadline_drops_a_chunking_row_and_a_scheduler_queued_request(
        paged):
    rng = np.random.default_rng(4)
    eng = _port(paged, num_slots=1,
                scheduler=SchedulerConfig(chunk_tokens=32))
    long_p = rng.integers(3, CFG.vocab_size, size=150).tolist()
    r_chunk = eng.submit(long_p, 4, deadline_s=600.0)
    eng.step()                                  # starts chunking
    assert list(eng._chunking) == [0]
    r_queued = eng.submit(rng.integers(3, 500, size=10).tolist(), 4,
                          deadline_s=600.0)
    assert eng._sched.queued == 1               # held by the scheduler
    for req in [eng._chunking[0][0]] + \
            [r for q in eng._sched._queues.values() for r in q]:
        req.deadline_at = 0.0                   # both expire now
    done = {c.request_id: c for c in eng.step()}
    assert done[r_chunk].finish_reason == "deadline"
    assert done[r_queued].finish_reason == "deadline"
    assert done[r_chunk].tokens == [] and done[r_queued].tokens == []
    assert not eng._chunking and eng._sched.queued == 0
    assert eng._free == [0] and eng.deadline_expired == 2
    if paged:
        st = eng.kv_pool_stats()
        assert st["free_blocks"] == st["num_blocks"]
    # the freed slot serves the next request
    nxt = eng.submit([5, 6, 7], 3)
    assert [c.request_id for c in _drive(eng, 1)] == [nxt]


def test_warm_restart_with_a_scheduler_bypasses_the_shed_gate(tmp_path):
    path = str(tmp_path / "j.sqlite3")
    prompts = _prompts(seed=8, lens=(30, 40, 50, 60, 70, 80))
    ref = [c.tokens for c in _port().generate(prompts, max_new_tokens=8)]
    eng = _port(journal=EngineJournal(path, checkpoint_every=1))
    for i, p in enumerate(prompts):
        eng.submit(p, 8, correlation_id=f"w-{i}")
    eng.step()
    assert eng.journal.depth() == len(prompts)
    del eng                                     # the process dies
    tight = SchedulerConfig(max_queue_depth=2, batch_shed_depth=1)
    eng2 = _port(journal=EngineJournal(path, checkpoint_every=1),
                 scheduler=tight)
    assert eng2.journal_replayed == len(prompts)   # nothing shed
    assert eng2.sched_stats()["shed"] == 0
    with pytest.raises(EngineOverloaded):
        eng2.submit([5, 6, 7], 2)               # fresh work does shed
    names = dict(eng2.journal_recovered)
    got = {names[c.request_id]: c.tokens
           for c in _drive(eng2, len(prompts))}
    assert got == {f"w-{i}": t for i, t in enumerate(ref)}
    assert eng2.journal.depth() == 0


def test_purge_queued_repays_the_schedulers_ledgers():
    eng = _port(num_slots=1, scheduler=Scheduler(SchedulerConfig()))
    for i in range(4):
        eng.submit([5, 6, 7, 8 + i], 4, tenant="t")
    eng.step()                                  # one admitted, rest held
    assert eng._sched.queued > 0
    sup = EngineSupervisor(eng)
    dropped = sup.purge_queued()
    assert len(dropped) == 3
    assert eng._sched.queued == 0 and eng.queue_depth == 0
    assert eng._sched.queued_for("t") == 0


def test_resource_breaker_lowers_the_cap_and_informs_the_scheduler():
    """The scheduler half of the JAX chaos suite's resource-breaker case,
    on the port's engine: repeated resource exhaustion halves the slot cap
    and raises the shed loop's pressure; clean dispatches after the
    cooldown restore both."""
    from copilot_for_consensus_tpu_torch.engine.supervisor import (
        SupervisorConfig,
    )

    class _Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = _Clock()
    eng = _port(scheduler=True)
    sup = EngineSupervisor(
        eng, SupervisorConfig(resource_breaker_threshold=2,
                              breaker_probe_after_s=10.0), clock=clk)
    oom = RuntimeError("CUDA out of memory. Tried to allocate 1.2 GiB")
    sup.on_dispatch_error("decode", oom)
    assert eng._slot_cap == 4
    sup.on_dispatch_error("decode", oom)
    assert eng._slot_cap == 2 and eng._sched.pressure == 1
    eng._sched.observe(queued=0, active=0, num_slots=4)
    assert eng._sched.overload_level == 1
    sup.on_dispatch_ok("decode")
    assert eng._slot_cap == 2                   # cooldown not elapsed
    clk.t = 10.0
    sup.on_dispatch_ok("decode")
    sup.on_dispatch_ok("decode")
    assert eng._slot_cap == 4 and eng._sched.pressure == 0
    assert sup.resource_breaker.state == "closed"
    eng._sched.observe(queued=0, active=0, num_slots=4)
    assert eng._sched.overload_level == 0


def test_chunked_prefill_on_an_fp8_cache_keeps_the_jax_engines_first_tokens():
    """The chunk pass over an fp8 slot cache (the mixed-traffic
    deployment's KV dtype): against the JAX chunked engine with the same
    KV dtype, each stream's first tokens agree (the bar of
    tests/test_torch_kv_dtype.py), and the prompts did chunk."""
    kw = dict(kv_dtype="float8_e4m3fn")
    eng = _port(scheduler=SchedulerConfig(chunk_tokens=64), **kw)
    got = [c.tokens for c in eng.generate(_prompts(), max_new_tokens=8)]
    jeng = JaxEngine(jax_config("tiny"), _weights()[0], dtype=jnp.float32,
                     attn_impl="xla", telemetry=False,
                     scheduler=JaxSchedulerConfig(chunk_tokens=64),
                     **{**KW, **kw})
    want = [c.tokens for c in jeng.generate(_prompts(), max_new_tokens=8)]
    for a, b in zip(got, want):
        assert a[:3] == b[:3], (a, b)
    assert eng.chunk_dispatches > 0
