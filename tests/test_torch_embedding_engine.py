# The port's EmbeddingEngine (engine/embedding.py) against the JAX
# package's on the CPU: the same weights (made by the JAX package, carried
# across with checkpoint/bridge.py), tokenizer and buckets give the same
# vectors at f32 within 1e-5; the reference's engine scenarios hold (order
# kept across buckets, batched equals single, empty and degenerate input,
# the vocab guard); the scheduler shrinks tiles, an injected "embed" fault
# reaches the caller, a telemetry record is written a dispatch; and
# from_checkpoint serves a BERT directory with a WordPiece tokenizer.json
# and refuses one without.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.embedding import (
    EmbeddingEngine as JaxEmbeddingEngine,
)
from copilot_for_consensus_tpu.models import encoder as jenc
from copilot_for_consensus_tpu.models.configs import (
    encoder_config as jax_encoder_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.embedding import EmbeddingEngine
from copilot_for_consensus_tpu_torch.engine.faults import (
    FaultSpec,
    InjectedFault,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import (
    Scheduler,
    SchedulerConfig,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    HashWordTokenizer,
)
from copilot_for_consensus_tpu_torch.models.configs import encoder_config

CFG = encoder_config("tiny")
BUCKETS = (8, 16, 32)
TEXTS = ["hello world", "consensus reached on the draft", "short",
         " ".join(["w"] * 100), "", "the working group agrees " * 3,
         "rough consensus and running code"]


@pytest.fixture(scope="module")
def jax_params():
    return jenc.init_params(jax.random.PRNGKey(0),
                            jax_encoder_config("tiny"), dtype=jnp.float32)


def _engine(jax_params=None, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("device", "cpu")
    params = None if jax_params is None else params_from_numpy(
        jax.tree.map(np.asarray, jax_params), "cpu", kw["dtype"])
    return EmbeddingEngine(CFG, params, **kw)


def test_embed_batch_equals_the_jax_engine(jax_params):
    want = JaxEmbeddingEngine(jax_encoder_config("tiny"), jax_params,
                              batch_size=4, buckets=BUCKETS,
                              dtype=jnp.float32,
                              attn_impl="xla").embed_batch(TEXTS)
    got = _engine(jax_params).embed_batch(TEXTS)
    assert got.shape == want.shape == (len(TEXTS), CFG.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_buckets_clip_to_max_positions():
    eng = _engine(buckets=(64, 128, 256, 512))
    assert eng.buckets == (64, 128)


def test_embed_batch_shape_and_norms():
    out = _engine().embed_batch(TEXTS[:4])
    assert out.shape == (4, CFG.d_model) and out.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-4)


def test_batched_equals_individual():
    eng = _engine()
    texts = [f"word{i} " * (i + 1) for i in range(9)]
    batched = eng.embed_batch(texts)
    for i, t in enumerate(texts):
        np.testing.assert_allclose(batched[i], eng.embed_batch([t])[0],
                                   rtol=1e-4, atol=1e-5)


def test_embed_single_parity():
    v = _engine().embed("the working group agrees")
    assert isinstance(v, list) and len(v) == CFG.d_model


def test_empty_and_degenerate_inputs():
    eng = _engine()
    assert eng.embed_batch([]).shape == (0, CFG.d_model)
    out = eng.embed_batch(["", "   "])
    assert out.shape == (2, CFG.d_model)
    assert np.all(np.isfinite(out))


def test_same_text_same_vector_different_text_different_vector():
    a, b, c = _engine().embed_batch(["alpha beta gamma", "alpha beta gamma",
                                     "totally different text here"])
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert np.linalg.norm(a - c) > 1e-3


def test_tokenizer_vocab_guard():
    with pytest.raises(ValueError, match="exceeds encoder vocab"):
        _engine(tokenizer=HashWordTokenizer(10 * CFG.vocab_size))


def test_scheduler_shrinks_the_tiles():
    sched = Scheduler(SchedulerConfig(embed_wave_rows=2))
    eng = _engine(batch_size=8, scheduler=sched)
    texts = [f"text {i}" for i in range(5)]
    want = _engine(batch_size=8).embed_batch(texts)
    got = eng.embed_batch(texts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    recs = eng.telemetry.recorder.records()
    assert [r.batch for r in recs] == [2, 2, 1]
    sched.overload_level = 1                 # overload halves the tile
    eng.embed_batch(texts)
    assert [r.batch for r in eng.telemetry.recorder.records()[3:]] == \
        [1] * 5


def test_an_injected_embed_fault_reaches_the_caller():
    eng = _engine(faults=[FaultSpec(kind="embed", at=2)])
    eng.embed_batch(["first dispatch"])
    with pytest.raises(InjectedFault, match="kind=embed"):
        eng.embed_batch(["second dispatch"])
    assert eng.faults.fired == [("embed", 2, "error")]
    eng.embed_batch(["third dispatch"])


def test_a_telemetry_record_a_dispatch():
    eng = _engine()
    eng.embed_batch(["hello world", "a longer text about consensus",
                     "third", " ".join(["w"] * 20)])
    recs = eng.telemetry.recorder.records()
    assert [r.kind for r in recs] == ["embed", "embed"]
    assert (recs[0].rows, recs[0].batch, recs[0].padded_tokens) == \
        (3, 4, 4 * 8)
    assert (recs[1].rows, recs[1].batch, recs[1].padded_tokens) == \
        (1, 1, 32)
    assert recs[1].tokens == 20
    assert "copilot_engine_step_seconds_bucket" in \
        eng.telemetry.metrics.render_prometheus()


def test_a_mesh_is_refused_naming_the_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _engine(mesh=object())


def test_the_engine_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingEngine(CFG)


# -- from_checkpoint ----------------------------------------------------

def _write_wordpiece_tokenizer(out_dir):
    """A tiny WordPiece tokenizer.json with the BERT post-processor, so
    encode() emits [CLS] ... [SEP] like MiniLM's."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for w in ("the", "quick", "brown", "fox", "lazy", "dog", "##s", "a"):
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.save(str(out_dir / "tokenizer.json"))


@pytest.fixture()
def bert_dir(tmp_path):
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2)).eval()
    out = tmp_path / "hf-bert"
    model.save_pretrained(out, safe_serialization=True)
    return out, model


def test_from_checkpoint_with_a_wordpiece_tokenizer(bert_dir):
    path, model = bert_dir
    _write_wordpiece_tokenizer(path)
    eng = EmbeddingEngine.from_checkpoint(str(path), device="cpu")
    assert eng.dimension == 64 and eng.tokenizer.pad_id == 0
    assert eng.params["tok_emb"].dtype == torch.float32
    assert eng.tokenizer.encode("the quick") == [2, 4, 5, 3]
    vecs = eng.embed_batch(["the quick brown fox", "a lazy dogs"])
    assert vecs.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0,
                               atol=1e-5)
    ids = eng.tokenizer.encode("the quick brown fox")
    with torch.no_grad():
        hidden = model(torch.tensor([ids])).last_hidden_state
    ref = torch.nn.functional.normalize(hidden.mean(1), dim=-1)[0].numpy()
    np.testing.assert_allclose(vecs[0], ref, atol=2e-4, rtol=1e-3)


def test_from_checkpoint_requires_a_tokenizer(bert_dir):
    path, _ = bert_dir
    with pytest.raises(ValueError, match="no tokenizer.json"):
        EmbeddingEngine.from_checkpoint(str(path), device="cpu")
