# The port's continuous-batching engine and summarizer against the JAX
# package's on the same weights, in float32: greedy token streams and
# summary texts must be EQUAL, for tiny and tiny-swa, int8 and plain.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
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
from copilot_for_consensus_tpu_torch.engine.sampling import SamplingConfig
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4)
# mixed lengths, more requests than slots: two admission waves, slot reuse
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]


def _weights(name, overrides):
    jcfg = jax_config(name, **overrides)
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("quantize", [False, "int8"])
@pytest.mark.parametrize("name,overrides", [
    ("tiny", {}), ("tiny-swa", {"sliding_window": 16})],
    ids=["tiny", "tiny-swa16"])
def test_greedy_streams_equal_jax_engine(name, overrides, quantize):
    jcfg, jp, tree = _weights(name, overrides)
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, quantize=quantize,
                     telemetry=False, **ENGINE_KW)
    teng = GenerationEngine(decoder_config(name, **overrides),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", quantize=quantize,
                            device="cpu", **ENGINE_KW)
    if quantize:
        assert tquant.is_quantized(teng.params["layers"]["wq"])
    assert teng.prompt_limit == jeng.prompt_limit
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
        assert g.prompt_len == w.prompt_len
    assert sum(len(g.tokens) for g in got) > 2 * len(PROMPTS)


def _threads(cls):
    return [cls(thread_id=f"t{i}", subject=f"Topic {i}",
                participants=["alice@example.org", "bob@example.org"],
                message_count=2 + i,
                chunks=[{"chunk_id": f"c{i}", "text": f"Point {i}: ship "
                         f"the draft by Friday."}])
            for i in range(3)]


def test_summaries_equal_tpu_summarizer():
    jcfg, jp, tree = _weights("tiny", {})
    kw = dict(num_slots=2, max_len=256, prefill_buckets=(128, 256),
              decode_window=4)
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, quantize="int8",
                     telemetry=False, **kw)
    teng = GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", quantize="int8", device="cpu",
                            **kw)
    want = TPUSummarizer("tiny", engine=jeng, max_new_tokens=10) \
        .summarize_batch(_threads(JaxThread))
    got = CUDASummarizer("tiny", engine=teng, max_new_tokens=10) \
        .summarize_batch(_threads(ThreadContext))
    for w, g in zip(want, got):
        assert g.summary_text == w.summary_text
        assert g.prompt_tokens == w.prompt_tokens
        assert g.completion_tokens == w.completion_tokens
        assert [c.snippet for c in g.citations] == \
            [c.snippet for c in w.citations]


def test_long_prompt_keeps_its_tail():
    eng = GenerationEngine(decoder_config("tiny"), dtype="float32",
                           device="cpu", **ENGINE_KW)
    prompt = list(range(3, 3 + 50))                 # limit is 32
    (comp,) = eng.generate([prompt], max_new_tokens=3)
    assert comp.prompt_len == eng.prompt_limit == 32
    full = tdec.forward(eng.params, torch.tensor([prompt[-32:]]), eng.cfg)
    assert comp.tokens[0] == int(full[0, -1].argmax())


def test_sampled_generation_is_seeded_and_in_vocab():
    def run(seed):
        eng = GenerationEngine(
            decoder_config("tiny"), dtype="float32", device="cpu", seed=seed,
            sampling=SamplingConfig(temperature=1.0, top_p=0.9), eos_id=-1,
            **ENGINE_KW)
        return [c.tokens for c in eng.generate(PROMPTS, max_new_tokens=8)]

    a, b = run(3), run(3)
    assert a == b
    assert all(len(t) == 8 and all(0 <= x < 512 for x in t) for t in a)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = decoder_config("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        CUDASummarizer("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tquant.init_random_quantized(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"final_norm": np.ones(4)}, None, "float32")
