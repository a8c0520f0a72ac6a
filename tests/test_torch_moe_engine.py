# The port's engines serving the Mixtral-class MoE decoder against the JAX
# package's, on the same tiny-moe weights in float32 on the CPU: greedy
# token streams EQUAL on the contiguous cache (plain, int8 and int4
# weights, and a two-window dispatch through the decode-graph runner's
# code), the paged pool, the prefill/decode roles, the contiguous prefix
# cache (a repeat round that hits), chunked prefill and speculative verify
# (the scheduler's and the verify pass's multi-token MoE waves), the
# long-context engine on a one-device mesh, and the summarizer built by
# the ``cuda`` driver with its long route and its async runner. Then a
# tiny Mixtral HF directory written here with numpy: both packages read it
# leaf for leaf (the router f32), and native int8 / int4 conversions of it
# serve streams equal to the JAX engine's.
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save

from copilot_for_consensus_tpu import checkpoint as jck
from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.longctx import (
    LongContextEngine as JaxLong,
)
from copilot_for_consensus_tpu.engine.sampling import (
    SamplingConfig as JaxSampling,
)
from copilot_for_consensus_tpu.engine.scheduler import (
    SchedulerConfig as JaxSchedulerConfig,
)
from copilot_for_consensus_tpu.models import decoder as jdec
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
from copilot_for_consensus_tpu_torch import checkpoint as tck
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    save_byte_tokenizer,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.longctx import LongContextEngine
from copilot_for_consensus_tpu_torch.engine.roles import DisaggregatedEngine
from copilot_for_consensus_tpu_torch.engine.sampling import SamplingConfig
from copilot_for_consensus_tpu_torch.engine.scheduler import SchedulerConfig
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.factory import (
    create_summarizer,
)

JCFG, CFG = jax_config("tiny-moe"), decoder_config("tiny-moe")
KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
          decode_window=4)
# mixed lengths, more requests than slots: two admission waves (rows and
# columns padded), slot reuse
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]
NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny shapes, token by token: an intra-op thread pool only slows them
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _weights(key=7):
    jp = jdec.init_params(jax.random.PRNGKey(key), JCFG, dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _jax(kw, **more):
    return JaxEngine(JCFG, _weights()[0], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla", telemetry=False,
                     **{**kw, **more})


def _port(kw, **more):
    return GenerationEngine(CFG, params_from_numpy(_weights()[1], "cpu",
                                                   "float32"),
                            dtype="float32", device="cpu", telemetry=False,
                            **{**kw, **more})


def _streams(eng, prompts=PROMPTS, new=NEW):
    return [c.tokens for c in eng.generate(prompts, max_new_tokens=new)]


# ---------------------------------------------------------------------------
# GenerationEngine routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize,windows", [
    (False, 1), ("int8", 1), ("int4", 1), ("int8", 2)],
    ids=["f32", "int8", "int4", "int8-two-windows"])
def test_contiguous_streams_equal_jax(quantize, windows):
    kw = {**KW, "quantize": quantize, "windows_per_dispatch": windows}
    want = _streams(_jax(kw))
    eng = _port(kw)
    got = _streams(eng)
    assert got == want
    assert sum(map(len, got)) > 2 * len(PROMPTS)
    if quantize == "int4":                          # unfused, as in JAX
        assert "wqkv" not in eng.params["layers"]
    # every decode dispatch ran the graph runner's body (eagerly here)
    assert eng.graph_stats()["eager"] > 0


PAGED = {**KW, "prefill_chunk": 16, "kv_pool_blocks": 64}


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_paged_streams_equal_jax(quantize):
    want = _streams(_jax(PAGED, quantize=quantize))
    eng = _port(PAGED, quantize=quantize)
    assert _streams(eng) == want
    st = eng.kv_pool_stats()
    assert st["free_blocks"] == st["num_blocks"]


@pytest.mark.parametrize("decode_kw", [
    {}, {"num_slots": 2, "kv_pool_blocks": 40}],
    ids=["equal_sides", "decode_backpressure"])
def test_roles_streams_equal_colocated_and_jax(decode_kw):
    # The prefill/decode roles, one CPU device each. The handed-off KV is
    # model-agnostic, but a role's waves and decode batches are its own,
    # and capacity drops depend on every row routed: the streams must
    # still equal the co-located engine's, the port's and the JAX
    # package's (whose roles run over a mesh, ROADMAP Queue 3).
    want = _streams(_jax(PAGED))
    assert _streams(_port(PAGED)) == want
    dis = DisaggregatedEngine(
        CFG, params_from_numpy(_weights()[1], "cpu", "float32"),
        devices=["cpu", "cpu"],
        engine_kw={**PAGED, "dtype": "float32", "telemetry": False},
        decode_kw=decode_kw)
    assert _streams(dis) == want
    st = dis.stats()
    assert st["handoffs"] == len(PROMPTS) and st["pending_handoffs"] == 0
    for eng in (dis.prefill, dis.decode):
        assert eng._pool.free_blocks == eng._pool.num_blocks


PREFIX = dict(num_slots=4, max_len=128, prefill_buckets=(32, 64),
              decode_window=4, prefill_chunk=16, prefix_cache_blocks=32)


def _shared_prompts(seed):
    """One 48-token head for every round, fresh 8-token tails."""
    head = np.random.default_rng(0).integers(3, CFG.vocab_size,
                                             size=48).tolist()
    rng = np.random.default_rng(seed + 1)
    return [head + rng.integers(3, CFG.vocab_size, size=8).tolist()
            for _ in range(3)]


def test_prefix_cache_repeat_round_equals_jax():
    jeng, teng = _jax(PREFIX), _port(PREFIX)
    for round_ in range(2):
        prompts = _shared_prompts(round_)
        assert _streams(teng, prompts, 8) == _streams(jeng, prompts, 8)
    assert teng.prefix_stats()["hits"] > 0
    assert teng.prefix_stats() == jeng.prefix_stats()


LONGER = dict(num_slots=4, max_len=128, prefill_buckets=(32, 64, 96),
              decode_window=4)


def _long_prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(3, CFG.vocab_size, size=n).tolist()
            for n in (70, 20, 45, 90)]


def test_chunked_prefill_streams_equal_jax():
    want_eng = _jax(LONGER, scheduler=JaxSchedulerConfig(chunk_tokens=16))
    want = _streams(want_eng, _long_prompts(), 8)
    eng = _port(LONGER, scheduler=SchedulerConfig(chunk_tokens=16))
    assert _streams(eng, _long_prompts(), 8) == want
    assert eng.sched_stats() == want_eng.sched_stats()
    assert eng.sched_stats()["chunk_dispatches"] > 0


def _copy_prompts():
    """Prompts whose back half repeats 8-token spans of the front half,
    so prompt-lookup drafts fire."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(4):
        head = rng.integers(3, CFG.vocab_size, size=24).tolist()
        tail = []
        while len(tail) < 24:
            s0 = int(rng.integers(0, 16))
            tail.extend(head[s0:s0 + 8])
        out.append(head + tail[:24])
    return out


def test_spec_verify_streams_equal_jax():
    # An MoE verify pass routes B x (k + 1) rows under one capacity, so its
    # drops are not plain decode's: spec-on streams may leave spec-off ones
    # in the JAX package too. Each is held to its JAX twin.
    kw = {**LONGER, "prefill_chunk": 32}
    jeng = _jax(kw, spec_decode=True)
    want = _streams(jeng, _copy_prompts(), 24)
    eng = _port(kw, spec_decode=True)
    assert _streams(eng, _copy_prompts(), 24) == want
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_stats()["verify_dispatches"] > 0
    assert _streams(_port(kw), _copy_prompts(), 24) == \
        _streams(_jax(kw), _copy_prompts(), 24)


# ---------------------------------------------------------------------------
# the long-context engine and the summarizer
# ---------------------------------------------------------------------------

LONG_KW = dict(decode_window=4, ctx_block=16, max_new_tokens=64)
LONG_PROMPT = np.random.default_rng(0).integers(3, 512, size=600).tolist()


def _mesh():
    return build_mesh(MeshConfig(sp=1, tp=1), devices=jax.devices()[:1])


def test_long_context_engine_equals_jax():
    jeng = JaxLong(JCFG, _weights()[0], mesh=_mesh(), dtype=jnp.float32,
                   sampling=JaxSampling(temperature=0.0), eos_id=-1,
                   telemetry=False, **LONG_KW)
    want = jeng.generate(LONG_PROMPT, max_new_tokens=10)
    teng = LongContextEngine(
        CFG, params_from_numpy(_weights()[1], "cpu", "float32"),
        dtype="float32", sampling=SamplingConfig(temperature=0.0),
        eos_id=-1, device="cpu", **LONG_KW)
    got = teng.generate(LONG_PROMPT, max_new_tokens=10)
    assert got.tokens == want.tokens and len(got.tokens) == 10
    assert got.prompt_len == want.prompt_len == 600


def _threads(cls):
    # a long thread, past the short engine's window, and a short one
    long = cls(thread_id="t-long", subject="big thread",
               participants=["a@x", "b@y"], message_count=8,
               chunks=[{"chunk_id": f"c{i}", "text": "consensus " * 30}
                       for i in range(8)])
    short = cls(thread_id="t-short", subject="hi", participants=["a@x"],
                message_count=1,
                chunks=[{"chunk_id": "s0", "text": "ship it"}])
    return [long, short]


def _as_jax_tree(tree):
    return {k: _as_jax_tree(v) if isinstance(v, dict)
            else jnp.asarray(v.numpy()) for k, v in tree.items()}


def test_cuda_driver_summarizer_serves_moe_like_jax():
    summ = create_summarizer(
        {"driver": "cuda", "model": "tiny-moe", "quantize": "int8",
         "num_slots": 2, "max_len": 256, "max_new_tokens": 8,
         "long_context": True, "device": "cpu"}, dtype="float32")
    eng = summ.engine
    assert eng.cfg == CFG and eng.quant_mode == "int8"
    assert summ.long_engine is not None
    # the JAX engines over the port's own random int8 weights
    jp = _as_jax_tree(eng.params)
    jeng = JaxEngine(JCFG, jp, dtype=jnp.float32, quantize="int8",
                     num_slots=2, max_len=256, telemetry=False)
    jlong = JaxLong(JCFG, jp, mesh=_mesh(), dtype=jnp.float32,
                    eos_id=sorted(jeng._eos_set), max_new_tokens=8,
                    telemetry=False)
    want = TPUSummarizer(engine=jeng, long_engine=jlong,
                         max_new_tokens=8).summarize_batch(
        _threads(JaxThread))
    got = summ.summarize_batch(_threads(ThreadContext))
    assert got[0].prompt_tokens > eng.prompt_limit     # the long route
    for g, w in zip(got, want):
        assert g.summary_text == w.summary_text
        assert (g.prompt_tokens, g.completion_tokens) == \
            (w.prompt_tokens, w.completion_tokens)
    # the async front end serves the same through the runner
    handles = [summ.summarize_async(t) for t in _threads(ThreadContext)]
    for h, w in zip(handles, want):
        assert h(120.0).summary_text == w.summary_text
    summ.close()


# ---------------------------------------------------------------------------
# Mixtral checkpoints
# ---------------------------------------------------------------------------

HF_MIXTRAL = {
    "model_type": "mixtral", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 128,
    "num_hidden_layers": 2, "vocab_size": 300,
    "max_position_embeddings": 256, "rope_theta": 1e6,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "sliding_window": None, "num_local_experts": 4,
    "num_experts_per_tok": 2, "bos_token_id": 1, "eos_token_id": 2,
}


def write_mixtral_dir(path, dtype=ml_dtypes.bfloat16):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF_MIXTRAL))
    rng = np.random.default_rng(3)
    c = HF_MIXTRAL
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    kv = d // c["num_attention_heads"] * c["num_key_value_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(dtype)

    out = {"model.embed_tokens.weight": w(v, d),
           "model.norm.weight": (1 + w(d)).astype(dtype),
           "lm_head.weight": w(v, d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (1 + w(d)).astype(dtype),
            p + "post_attention_layernorm.weight": (1 + w(d)).astype(dtype),
            p + "self_attn.q_proj.weight": w(d, d),
            p + "self_attn.k_proj.weight": w(kv, d),
            p + "self_attn.v_proj.weight": w(kv, d),
            p + "self_attn.o_proj.weight": w(d, d),
            p + "block_sparse_moe.gate.weight": w(
                c["num_local_experts"], d)})
        for j in range(c["num_local_experts"]):
            e = p + f"block_sparse_moe.experts.{j}."
            out.update({e + "w1.weight": w(f, d), e + "w3.weight": w(f, d),
                        e + "w2.weight": w(d, f)})
    st_save(out, str(path / "model.safetensors"))
    save_byte_tokenizer(path)
    return path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mixtral_hf_dir_loads_leaf_for_leaf_like_jax(dtype, tmp_path):
    path = write_mixtral_dir(tmp_path)
    cfg, params = tck.load_hf_checkpoint(path, dtype)
    jcfg, jparams = jck.load_hf_checkpoint(path, dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_experts == 4 and cfg.experts_per_token == 2
    a, b = _flat(params), _flat(jparams)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = _np(a[k]), _np(b[k])
        assert x.dtype.itemsize == y.dtype.itemsize, k
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["router"].shape == (2, 64, 4)
    assert params["layers"]["w_down"].shape == (2, 4, 128, 64)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_mixtral_native_checkpoint_serves_like_jax(quantize, tmp_path):
    src = write_mixtral_dir(tmp_path / "hf")
    # f32 leaves beside the quantized ones: both engines compute in f32
    meta = tck.convert(src, tmp_path / "native", quantize=quantize,
                       dtype="float32")
    assert meta["quantized"] == quantize
    jeng = JaxEngine.from_checkpoint(str(tmp_path / "native"),
                                     dtype=jnp.float32, telemetry=False,
                                     **KW)
    teng = GenerationEngine.from_checkpoint(tmp_path / "native",
                                            dtype="float32", device="cpu",
                                            **KW)
    assert teng.quant_mode == quantize
    assert teng.params["layers"]["router"].dtype == torch.float32
    want = [c.tokens for c in jeng.generate(PROMPTS, max_new_tokens=NEW)]
    assert _streams(teng) == want
