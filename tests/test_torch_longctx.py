# The port's LongContextEngine against the JAX package's on a one-device
# sequence mesh (sp = 1, as on one card), in float32 on the CPU: greedy
# streams equal and first-token logits within 1e-5 for a 600-token prompt
# (past tiny's 512-token max_seq_len), dense and sliding-window, ring and
# Ulysses, int8 and int4 params; EOS; and the summarizer's long route, sync
# and async with the runner live, equal to the JAX summarizer's.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.longctx import (
    LongContextEngine as JaxLong,
)
from copilot_for_consensus_tpu.engine.sampling import (
    SamplingConfig as JaxSampling,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.parallel import MeshConfig, build_mesh
from copilot_for_consensus_tpu.summarization.base import (
    ThreadContext as JaxThread,
)
from copilot_for_consensus_tpu.summarization.tpu_summarizer import (
    TPUSummarizer,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.longctx import (
    LongContextEngine,
    _round_up,
)
from copilot_for_consensus_tpu_torch.engine.sampling import SamplingConfig
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

#: the JAX package's long-context test's engine (tests/test_engine_longctx
#: .py): window 4, ctx_block 16, 64 new tokens at most
LONG_KW = dict(decode_window=4, ctx_block=16, max_new_tokens=64)
NEW = 10
PROMPT = np.random.default_rng(0).integers(3, 512, size=600).tolist()
LOGITS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny shapes: thousands of small ops a decode, which an intra-op
    # thread pool only slows, the more so beside other test workers
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _restore_pallas_flag():
    # a JAX LongContextEngine over quantized params flips the JAX
    # package's process-wide qmatmul route (quant.set_pallas_qmatmul)
    saved = jquant._PALLAS_QMATMUL
    yield
    jquant._PALLAS_QMATMUL = saved


def _mesh(n=1):
    return build_mesh(MeshConfig(sp=n, tp=1), devices=jax.devices()[:n])


def _jax_params(name, key=0, mode=None):
    jcfg = jax_config(name)
    jp = jdec.init_params(jax.random.PRNGKey(key), jcfg, dtype=jnp.float32)
    if mode:
        jp = jquant.quantize_params(jp, mode=mode)
    return jcfg, jp


def _port(jp, name, **kw):
    tree = jax.tree.map(np.asarray, jp)
    return LongContextEngine(
        decoder_config(name), params_from_numpy(tree, "cpu", "float32"),
        dtype="float32", sampling=SamplingConfig(temperature=0.0),
        eos_id=kw.pop("eos_id", -1), device="cpu", **LONG_KW, **kw)


def _jax_run(jcfg, jp, sp_impl="ring", prompt=PROMPT, new=NEW):
    """(tokens, first-token logits) of the JAX engine on one device."""
    eng = JaxLong(jcfg, jp, mesh=_mesh(), dtype=jnp.float32,
                  sampling=JaxSampling(temperature=0.0), eos_id=-1,
                  sp_impl=sp_impl, telemetry=False, **LONG_KW)
    comp = eng.generate(prompt, max_new_tokens=new)
    s_ctx = _round_up(len(prompt), eng.ctx_quantum)
    tokens = np.zeros((1, s_ctx), dtype=np.int32)
    tokens[0, :len(prompt)] = prompt
    logits, _ = eng._prefill_jits[s_ctx](
        eng.params, jnp.asarray(tokens),
        jnp.asarray([len(prompt)], dtype=jnp.int32))
    return comp, np.asarray(logits)


def _port_logits(eng, prompt=PROMPT):
    s_ctx = _round_up(len(prompt), eng.ctx_quantum)
    with torch.inference_mode():
        logits, _ = eng._prefill(prompt, s_ctx)
    return logits.numpy()


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX engine built and run once for the module."""
    out = {}
    for name in ("tiny", "tiny-swa"):
        jcfg, jp = _jax_params(name)
        out[name] = (jp,) + _jax_run(jcfg, jp)
    jcfg, jp = _jax_params("tiny")
    out["ulysses"] = (jp,) + _jax_run(jcfg, jp, sp_impl="ulysses")
    for mode in ("int8", "int4"):
        saved = jquant._PALLAS_QMATMUL
        jcfg, jq = _jax_params("tiny", key=3, mode=mode)
        out[mode] = (jq,) + _jax_run(jcfg, jq)
        jquant._PALLAS_QMATMUL = saved
    return out


@pytest.mark.parametrize("name", ["tiny", "tiny-swa"])
def test_greedy_streams_and_first_logits_equal_jax(name, jax_runs):
    jp, want, want_logits = jax_runs[name]
    assert len(PROMPT) > decoder_config(name).max_seq_len
    eng = _port(jp, name)
    got = eng.generate(PROMPT, max_new_tokens=NEW)
    assert got.tokens == want.tokens
    assert (got.prompt_len, got.finish_reason) == (600, "length")
    assert want.prompt_len == 600 and len(got.tokens) == NEW
    np.testing.assert_allclose(_port_logits(eng), want_logits, rtol=0,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_ring_and_ulysses_equal_each_other_and_jax(sp_impl, jax_runs):
    jp, want, _ = jax_runs["tiny"]
    _, want_u, _ = jax_runs["ulysses"]
    assert want_u.tokens == want.tokens
    got = _port(jp, "tiny", sp_impl=sp_impl).generate(PROMPT, NEW)
    assert got.tokens == want.tokens


@pytest.mark.parametrize("mode,fused", [("int8", False), ("int4", False),
                                        ("int4", True)],
                         ids=["int8", "int4", "int4-fused"])
def test_quantized_params_equal_jax(mode, fused, jax_runs):
    jq, want, want_logits = jax_runs[mode]
    tree = jax.tree.map(np.asarray, jq)
    params = params_from_numpy(tree, "cpu", "float32")
    if fused:
        # the int4 short engine's layout, which the summarizer hands over
        params = tquant.fuse_int4_projections(params)
    eng = LongContextEngine(decoder_config("tiny"), params, dtype="float32",
                            sampling=SamplingConfig(temperature=0.0),
                            eos_id=-1, device="cpu", **LONG_KW)
    assert eng.quant_mode == mode
    got = eng.generate(PROMPT, max_new_tokens=NEW)
    assert got.tokens == want.tokens
    np.testing.assert_allclose(_port_logits(eng), want_logits, rtol=0,
                               atol=LOGITS_ATOL)


def test_eos_stops_decode(jax_runs):
    jp, want, _ = jax_runs["tiny"]
    # the third greedy token declared EOS: generation stops before it
    got = _port(jp, "tiny", eos_id=want.tokens[2]).generate(PROMPT, NEW)
    assert got.finish_reason == "eos" and got.tokens == want.tokens[:2]
    # the first token an EOS (one of several ids): nothing is emitted
    got = _port(jp, "tiny", eos_id=[1, want.tokens[0]]).generate(PROMPT,
                                                                  NEW)
    assert got.finish_reason == "eos" and got.tokens == []
    # the suffix buffer caps the budget, as in the reference
    eng = _port(jp, "tiny")
    assert eng.suffix_len == 128
    assert len(eng.generate(PROMPT[:40], 500).tokens) == 127


def test_engine_keeps_the_tensors_it_is_given():
    cfg = decoder_config("tiny")
    short = GenerationEngine(cfg, dtype="float32", quantize="int8",
                             device="cpu", num_slots=2, max_len=128)
    eng = LongContextEngine(cfg, short.params, dtype="float32",
                            device="cpu")
    assert eng.params is short.params
    assert eng.quant_mode == "int8"
    lq = short.params["layers"]["wq"]["q"]
    assert eng.params["layers"]["wq"]["q"].data_ptr() == lq.data_ptr()


def test_mesh_and_sp_impl_rules():
    cfg = decoder_config("tiny")
    # a one-device sequence mesh is the engine itself
    LongContextEngine(cfg, mesh=_mesh(1), dtype="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6c"):
        LongContextEngine(cfg, mesh=_mesh(2), dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="ring|ulysses"):
        LongContextEngine(cfg, sp_impl="tree", dtype="float32",
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LongContextEngine(cfg, dtype="float32")


def test_telemetry_records_the_reference_steps(jax_runs):
    jp, want, _ = jax_runs["tiny"]
    eng = _port(jp, "tiny")
    eng.generate(PROMPT, NEW, correlation_id="evt-1")
    steps = eng.telemetry.recorder.records()
    kinds = [s.kind for s in steps]
    # one prefill, then ceil((NEW - 1) / window) decode dispatches
    assert kinds == ["prefill"] + ["decode"] * 3
    assert steps[0].tokens == 600 and steps[0].padded_tokens == 608
    assert all(s.padded_tokens == LONG_KW["decode_window"]
               for s in steps[1:])


# -- the summarizer's long route ---------------------------------------

SUMM_KW = dict(num_slots=2, max_len=512, prefill_buckets=(256, 512),
               decode_window=4)
SUMM_NEW = 8


def _threads(cls):
    # a long thread (~8 dense chunks, far past the 508-token window) and
    # a short one
    long = cls(thread_id="t-long", subject="big thread",
               participants=["a@x", "b@y"], message_count=8,
               chunks=[{"chunk_id": f"c{i}", "text": "consensus " * 40}
                       for i in range(8)])
    short = cls(thread_id="t-short", subject="hi", participants=["a@x"],
                message_count=1,
                chunks=[{"chunk_id": "s0", "text": "ship it"}])
    return [long, short]


@pytest.fixture(scope="module")
def summarizers():
    jcfg, jp = _jax_params("tiny", key=2)
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, telemetry=False,
                     **SUMM_KW)
    jlong = JaxLong(jcfg, jp, mesh=_mesh(), dtype=jnp.float32,
                    eos_id=sorted(jeng._eos_set), max_new_tokens=SUMM_NEW,
                    telemetry=False)
    want = TPUSummarizer(engine=jeng, long_engine=jlong,
                         max_new_tokens=SUMM_NEW).summarize_batch(
        _threads(JaxThread))
    teng = GenerationEngine(
        decoder_config("tiny"),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32"),
        dtype="float32", device="cpu", **SUMM_KW)
    summ = CUDASummarizer("tiny", engine=teng, max_new_tokens=SUMM_NEW,
                          long_context=True)
    return want, summ


def _same(got, want):
    assert got.thread_id == want.thread_id
    assert got.summary_text == want.summary_text
    assert got.prompt_tokens == want.prompt_tokens
    assert got.completion_tokens == want.completion_tokens
    assert len(got.citations) == len(want.citations)


def test_summarizer_routes_a_long_thread_whole(summarizers):
    want, summ = summarizers
    long_eng = summ.long_engine
    assert long_eng.params is summ.engine.params
    calls = []
    orig = long_eng.generate

    def spy(prompt, max_new_tokens=256, **kw):
        calls.append(len(prompt))
        return orig(prompt, max_new_tokens, **kw)

    long_eng.generate = spy
    try:
        got = summ.summarize_batch(_threads(ThreadContext))
    finally:
        del long_eng.generate
    # the long prompt went whole to the long engine, the short one not
    assert calls == [got[0].prompt_tokens]
    assert got[0].prompt_tokens > summ.engine.prompt_limit
    assert got[1].prompt_tokens < summ.engine.prompt_limit
    for g, w in zip(got, want):
        _same(g, w)
    _same(summ.summarize(_threads(ThreadContext)[0]), want[0])


def test_summarize_async_runs_a_long_thread_whole_beside_the_runner(
        summarizers):
    want, summ = summarizers
    long_t, short_t = _threads(ThreadContext)
    try:
        short_wait = summ.summarize_async(short_t, correlation_id="s")
        assert summ._runner is not None          # the runner is live
        long_wait = summ.summarize_async(long_t, correlation_id="l")
        _same(long_wait(), want[0])
        _same(short_wait(timeout=60.0), want[1])
        # a sync batch with the runner live: short through the runner,
        # long on the caller's thread
        for g, w in zip(summ.summarize_batch(_threads(ThreadContext)),
                        want):
            _same(g, w)
    finally:
        summ.close()
    rec = summ.long_engine.telemetry.recorder.records()
    assert rec and {s.kind for s in rec} == {"prefill", "decode"}


def test_split_counters_are_one_set_a_stream(monkeypatch):
    # the long engine's stream and the runner's each sum their stream
    # bodies' splits through their own counters: one set a (device,
    # stream), kept across calls
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "_stream_counters", {})
    dev = torch.device("cpu")
    stream = iter([11, 22, 11, 22])
    monkeypatch.setattr(qm, "_stream_of", lambda device: next(stream))
    a, b = qm._counters(dev, 8), qm._counters(dev, 8)
    assert a is not b
    assert qm._counters(dev, 8) is a and qm._counters(dev, 8) is b
    assert a.dtype == torch.int32 and not a.any()


@pytest.mark.parametrize("name", ["tiny", "tiny-swa"])
def test_bf16_first_logits_within_k1_tolerance(name):
    # bf16 weights and KV on both sides: the first-token logits within
    # K1's bf16 tolerance, 2e-2, relative to the largest logit (bf16
    # logits of magnitude ~3 carry steps of 2**-7 and more after two bf16
    # layers rounded in another order) and in relative L2
    jcfg = jax_config(name)
    jp = jdec.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    eng = JaxLong(jcfg, jp, mesh=_mesh(), dtype=jnp.bfloat16, eos_id=-1,
                  telemetry=False, **LONG_KW)
    s_ctx = _round_up(len(PROMPT), eng.ctx_quantum)
    tokens = np.zeros((1, s_ctx), dtype=np.int32)
    tokens[0, :len(PROMPT)] = PROMPT
    want, _ = eng._build_prefill(s_ctx)(
        eng.params, jnp.asarray(tokens),
        jnp.asarray([len(PROMPT)], dtype=jnp.int32))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    teng = LongContextEngine(decoder_config(name),
                             params_from_numpy(tree, "cpu", "bfloat16"),
                             dtype="bfloat16", eos_id=-1, device="cpu",
                             **LONG_KW)
    got = _port_logits(teng)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_concurrent_generates_serialize_on_the_engine():
    # summarize_async runs long prompts on the callers' threads: more
    # threads than cores, a short switch interval, one engine — each call
    # equals the serial result, and every call is its own request
    import sys
    import threading

    eng = LongContextEngine(decoder_config("tiny"), dtype="float32",
                            eos_id=-1, device="cpu", **LONG_KW)
    prompt = PROMPT[:48]
    want = eng.generate(prompt, 6).tokens
    n = 12
    got: list = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(
                i, eng.generate(prompt, 6).tokens)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == [want] * n
    assert eng._tele_rid == n + 1
    recs = eng.telemetry.recorder.records()
    assert sum(r.kind == "prefill" for r in recs) == n + 1
    assert len({r.seq for r in recs}) == len(recs)
