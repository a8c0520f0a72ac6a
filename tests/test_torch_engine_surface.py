# The engine's last public parts against the JAX engine's, in float32 on
# the CPU: generate_text (the port of tests/test_engine_generation.py's
# round trip and tests/test_checkpoint.py's from-checkpoint drive), its
# "tokenize" fault point (tests/test_engine_chaos.py), the active_count
# property and attn_impl.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu import checkpoint as jck
from copilot_for_consensus_tpu.engine.faults import (
    FaultPlan as JaxFaultPlan,
    FaultSpec as JaxFaultSpec,
    InjectedFault as JaxInjectedFault,
)
from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch import checkpoint as tck
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    save_byte_tokenizer,
)
from copilot_for_consensus_tpu_torch.engine.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4)
TEXTS = ["hi", "ok", "consensus on the draft?"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny shapes: thousands of small ops a decode, which an intra-op
    # thread pool only slows, the more so beside other test workers
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                       "float32")


def _engines(weights, **kw):
    jcfg, jp, tp = weights
    jkw = {"attn_impl": "xla", **{k: v[0] for k, v in kw.items()}}
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, telemetry=False,
                     **ENGINE_KW, **jkw)
    teng = GenerationEngine(decoder_config("tiny"), tp, dtype="float32",
                            device="cpu", **ENGINE_KW,
                            **{k: v[1] for k, v in kw.items()})
    return jeng, teng


def test_generate_text_roundtrip_equals_jax(weights):
    jeng, teng = _engines(weights)
    want = jeng.generate_text(TEXTS, JaxByteTokenizer(512),
                              max_new_tokens=6)
    got = teng.generate_text(TEXTS, ByteTokenizer(512), max_new_tokens=6)
    assert len(got) == len(TEXTS) and all(isinstance(g, str) for g in got)
    assert got == want


def test_generate_text_from_checkpoint_equals_jax(tmp_path):
    # an int8 native checkpoint with its tokenizer.json, both engines on
    # their plain attention (the JAX test's attn_impl="xla")
    jcfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jquant.quantize_params(jp))
    jck.save_native(tmp_path, jcfg, tree, bos_id=1, eos_id=2)
    save_byte_tokenizer(tmp_path)
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,))
    jeng = JaxEngine.from_checkpoint(str(tmp_path), dtype=jnp.float32,
                                     attn_impl="xla", telemetry=False, **kw)
    teng = GenerationEngine.from_checkpoint(tmp_path, dtype="float32",
                                            attn_impl="plain",
                                            device="cpu", **kw)
    assert teng.attn_impl == "plain" and teng.quant_mode == "int8"
    jtok, ttok = jck.load_tokenizer(tmp_path), tck.load_tokenizer(tmp_path)
    assert (ttok.bos_id, ttok.eos_id) == (jtok.bos_id, jtok.eos_id) == (1, 2)
    prompt = ["hello consensus draft"]
    want = jeng.generate_text(prompt, jtok, max_new_tokens=8)
    got = teng.generate_text(prompt, ttok, max_new_tokens=8)
    assert len(got) == 1 and isinstance(got[0], str)
    assert got == want


def test_tokenize_fault_point_fires_in_generate_text(weights):
    def plan(cls_plan, cls_spec):
        return cls_plan(specs=[cls_spec(kind="tokenize", at=1, count=1)])

    jeng, teng = _engines(weights, faults=(
        plan(JaxFaultPlan, JaxFaultSpec), plan(FaultPlan, FaultSpec)))
    with pytest.raises(JaxInjectedFault):
        jeng.generate_text(["hello"], JaxByteTokenizer(512),
                           max_new_tokens=2)
    with pytest.raises(InjectedFault):
        teng.generate_text(["hello"], ByteTokenizer(512), max_new_tokens=2)
    # the fault fired before any request: nothing was submitted
    assert teng.queue_depth == 0 and teng._next_id == 0
    # the next call goes through, as the JAX engine's does
    want = jeng.generate_text(["hello"], JaxByteTokenizer(512),
                              max_new_tokens=4)
    assert teng.generate_text(["hello"], ByteTokenizer(512),
                              max_new_tokens=4) == want


def test_active_count_follows_the_jax_engine(weights):
    jeng, teng = _engines(weights)
    prompts = [[5, 9, 13], list(range(40, 61)), [7] * 9,
               list(range(100, 130)), [3, 4], list(range(200, 214))]
    for p in prompts:
        jeng.submit(p, 6)
        teng.submit(p, 6)
    assert teng.active_count == jeng.active_count == 0
    seen = []
    while jeng.queue_depth or jeng.active_count or teng.active_count:
        jeng.step()
        teng.step()
        assert teng.active_count == jeng.active_count
        seen.append(teng.active_count)
    assert max(seen) == ENGINE_KW["num_slots"]


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_attn_impl_streams_equal_jax(impl, weights):
    jeng, teng = _engines(weights, attn_impl=("xla", impl))
    assert teng.attn_impl == impl
    prompts = [[5, 9, 13], list(range(40, 61))]
    want = jeng.generate(prompts, max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_attn_impl_plain_takes_the_plain_attention(weights, monkeypatch):
    # "plain" reaches every prefill wave: K1's wrapper is never called
    from copilot_for_consensus_tpu_torch.ops import attention as A

    calls = []
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a, **k: calls.append(1))
    _, teng = _engines(weights, attn_impl=("xla", "plain"))
    teng.generate([[5, 9, 13]], max_new_tokens=3)
    assert calls == []


def test_attn_impl_refusals():
    cfg = decoder_config("tiny")
    with pytest.raises(NotImplementedError, match="item 6c"):
        GenerationEngine(cfg, dtype="float32", device="cpu",
                         attn_impl=lambda *a, **k: None)
    with pytest.raises(ValueError, match="attn_impl"):
        GenerationEngine(cfg, dtype="float32", device="cpu",
                         attn_impl="xla")
