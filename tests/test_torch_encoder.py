# The port's sentence encoder (models/encoder.py, layers.layer_norm and
# layers.gelu_mlp) against the JAX package's on the CPU: the same weights,
# made by the JAX package and carried across with checkpoint/bridge.py, and
# the same tokens give the same vectors (f32: rtol 1e-4, atol 1e-5, the
# reference's own tolerance; bf16: cosine >= 0.999); padding and batching
# change nothing; the port's BERT reader (checkpoint/hf.py) gives
# transformers' BertModel vectors and refuses what the JAX reader refuses.
# On the CPU K1 is its plain version.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu import checkpoint as jck
from copilot_for_consensus_tpu.models import encoder as jenc
from copilot_for_consensus_tpu.models import layers as jlayers
from copilot_for_consensus_tpu.models.configs import (
    encoder_config as jax_encoder_config,
)
from copilot_for_consensus_tpu_torch import checkpoint as tck
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.models import encoder as tenc
from copilot_for_consensus_tpu_torch.models import layers as tlayers
from copilot_for_consensus_tpu_torch.models.configs import (
    ENCODER_CONFIGS,
    encoder_config,
)

#: the test configs: tiny (head dim 16) and one at minilm-l6's head dim 32
CONFIGS = {"tiny": {}, "d32": {"d_model": 64, "n_heads": 2}}


def _pair(name, dtype=jnp.float32, seed=0):
    """(JAX cfg, port cfg, JAX params, the same params on the port)."""
    jc = jax_encoder_config("tiny", **CONFIGS[name])
    tc = encoder_config("tiny", **CONFIGS[name])
    jp = jenc.init_params(jax.random.PRNGKey(seed), jc, dtype=dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32 if dtype == jnp.float32
                           else torch.bfloat16)
    return jc, tc, jp, tp


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_encode(jp, tokens, lengths, jc):
    return np.asarray(jenc.encode(jp, jnp.asarray(tokens),
                                  jnp.asarray(lengths, jnp.int32), jc,
                                  attn_impl="xla"), dtype=np.float32)


def _port_encode(tp, tokens, lengths, tc):
    return tenc.encode(tp, torch.from_numpy(tokens),
                       torch.tensor(lengths, dtype=torch.int32), tc).numpy()


def test_configs_equal_the_jax_package():
    from copilot_for_consensus_tpu.models.configs import ENCODER_CONFIGS as J

    assert sorted(ENCODER_CONFIGS) == sorted(J) == ["minilm-l6", "tiny"]
    for name, cfg in ENCODER_CONFIGS.items():
        assert vars(cfg) == vars(J[name])
    assert ENCODER_CONFIGS["minilm-l6"].head_dim == 32


def test_layer_norm_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(x, w, b, 1e-12))
    got = tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), 1e-12).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_layer_norm_keeps_the_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    out = tlayers.layer_norm(x, torch.ones(8), torch.zeros(8), 1e-12)
    assert out.dtype == torch.bfloat16


def test_gelu_mlp_equals_jax_with_exact_erf():
    rng = np.random.default_rng(1)
    layer = {"w_in": rng.standard_normal((32, 64)).astype(np.float32) / 6,
             "b_in": rng.standard_normal(64).astype(np.float32),
             "w_out": rng.standard_normal((64, 32)).astype(np.float32) / 8,
             "b_out": rng.standard_normal(32).astype(np.float32)}
    x = rng.standard_normal((4, 7, 32)).astype(np.float32)
    want = np.asarray(jlayers.gelu_mlp(x, layer))
    got = tlayers.gelu_mlp(torch.from_numpy(x),
                           {k: torch.from_numpy(v)
                            for k, v in layer.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the tanh approximation is measurably off: the test would see it
    tanh = torch.nn.functional.gelu(
        torch.from_numpy(x @ layer["w_in"] + layer["b_in"]),
        approximate="tanh").numpy() @ layer["w_out"] + layer["b_out"]
    assert np.abs(tanh - want).max() > 1e-5


def test_init_params_has_the_jax_leaves_and_shapes():
    jc = jax_encoder_config("tiny")
    jp = jenc.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    tp = tenc.init_params(encoder_config("tiny"), seed=0,
                          dtype=torch.float32, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes
    assert float(tp["tok_emb"].abs().max()) <= 2 * 64 ** -0.5 + 1e-6
    assert torch.equal(tp["layers"]["attn_norm_w"],
                       torch.ones_like(tp["layers"]["attn_norm_w"]))
    again = tenc.init_params(encoder_config("tiny"), seed=0,
                             dtype=torch.float32, device="cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_equals_jax_f32(name):
    jc, tc, jp, tp = _pair(name)
    tokens = _tokens(jc, 4, 32, seed=1)
    lengths = [32, 20, 5, 1]
    want = _jax_encode(jp, tokens, lengths, jc)
    got = _port_encode(tp, tokens, lengths, tc)
    assert got.shape == (4, jc.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_equals_jax_bf16_by_cosine(name):
    jc, tc, jp, tp = _pair(name, dtype=jnp.bfloat16)
    tokens = _tokens(jc, 4, 64, seed=2)
    lengths = [64, 33, 7, 2]
    want = _jax_encode(jp, tokens, lengths, jc)
    got = _port_encode(tp, tokens, lengths, tc)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_padding_does_not_change_the_embedding(name):
    _, tc, _, tp = _pair(name)
    tokens = _tokens(tc, 1, 10, seed=3)
    a = _port_encode(tp, tokens, [10], tc)
    padded = np.pad(tokens, ((0, 0), (0, 22)), constant_values=3)
    b = _port_encode(tp, padded, [10], tc)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cross_text_batching_matches_single(name):
    _, tc, _, tp = _pair(name)
    t1, t2 = _tokens(tc, 1, 16, seed=4), _tokens(tc, 1, 16, seed=5)
    batched = _port_encode(tp, np.concatenate([t1, t2]), [16, 16], tc)
    s1 = _port_encode(tp, t1, [16], tc)
    s2 = _port_encode(tp, t2, [16], tc)
    np.testing.assert_allclose(batched, np.concatenate([s1, s2]),
                               rtol=1e-4, atol=1e-5)


def test_encode_plain_attention_equals_auto_on_the_cpu():
    _, tc, _, tp = _pair("d32")
    tokens = _tokens(tc, 3, 24, seed=6)
    lengths = torch.tensor([24, 9, 1], dtype=torch.int32)
    a = tenc.encode(tp, torch.from_numpy(tokens), lengths, tc)
    b = tenc.encode(tp, torch.from_numpy(tokens), lengths, tc,
                    attn_impl="plain")
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "d32"),
                                        (torch.float32, "simt")])
def test_minilm_attention_takes_the_d32_body_at_bf16(dtype, body):
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    # minilm-l6's 12 heads of 32: at bf16 (the embedding engine's dtype)
    # K1's tensor-core d32 body, at f32 the CUDA-core body
    head_dim = encoder_config("minilm-l6").head_dim
    assert head_dim == 32
    assert tfa.flash_body(dtype, head_dim) == body


def test_encode_refuses_more_than_max_positions():
    _, tc, _, tp = _pair("tiny")
    tokens = torch.zeros((1, tc.max_positions + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds max_positions 128; the "
                                         "caller must truncate or window"):
        tenc.encode(tp, tokens, torch.tensor([1]), tc)


def test_init_params_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.init_params(encoder_config("tiny"))


# -- the BERT reader ----------------------------------------------------

@pytest.fixture()
def transformers():
    return pytest.importorskip("transformers")


def _tiny_bert_dir(transformers, tmp_path, *, prefixed=False):
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2)
    cls = (transformers.BertForMaskedLM if prefixed
           else transformers.BertModel)
    model = cls(cfg).to(torch.float32).eval()
    out = tmp_path / "hf-bert"
    model.save_pretrained(out, safe_serialization=True)
    return out, (model.bert if prefixed else model)


def _ref_mean_pooled(model, tokens, lengths):
    """sentence-transformers' masked mean pool + L2 norm over BertModel's
    last hidden state."""
    with torch.no_grad():
        mask = (torch.arange(tokens.shape[1])[None, :]
                < torch.tensor(lengths)[:, None])
        out = model(torch.from_numpy(tokens).long(),
                    attention_mask=mask.long()).last_hidden_state
        pooled = (out * mask[..., None]).sum(1) / mask.sum(1)[:, None]
        return torch.nn.functional.normalize(pooled, dim=-1).numpy()


@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "bert."])
def test_golden_embeddings_bert(transformers, tmp_path, prefixed):
    path, model = _tiny_bert_dir(transformers, tmp_path, prefixed=prefixed)
    cfg, params = tck.load_hf_encoder_checkpoint(path, dtype="float32")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.head_dim) == \
        (64, 2, 2, 32)
    assert cfg.vocab_size == 128 and cfg.max_positions == 64
    tokens = np.array([[2, 9, 17, 42, 3, 0, 0, 0],
                       [2, 100, 5, 3, 0, 0, 0, 0]], dtype=np.int32)
    lengths = [5, 4]
    ref = _ref_mean_pooled(model, tokens, lengths)
    got = _port_encode(params_from_numpy(params, "cpu", torch.float32),
                       tokens, lengths, cfg)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_reader_gives_the_jax_readers_leaves(transformers, tmp_path):
    path, _ = _tiny_bert_dir(transformers, tmp_path)
    jcfg, jp = jck.load_hf_encoder_checkpoint(path, dtype="float32")
    tcfg, tp = tck.load_hf_encoder_checkpoint(path, dtype="float32")
    assert vars(jcfg) == vars(tcfg)
    flat_j = {k: v for k, v in jp.items() if k != "layers"}
    flat_j.update({f"layers/{k}": v for k, v in jp["layers"].items()})
    flat_t = {k: v for k, v in tp.items() if k != "layers"}
    flat_t.update({f"layers/{k}": v for k, v in tp["layers"].items()})
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        assert flat_t[k].dtype == torch.float32
        np.testing.assert_array_equal(flat_t[k].numpy(),
                                      np.asarray(flat_j[k]), err_msg=k)
    _, tp16 = tck.load_hf_encoder_checkpoint(path, dtype="bfloat16")
    assert tp16["layers"]["wq"].dtype == torch.bfloat16


_BERT = {"model_type": "bert", "vocab_size": 128, "hidden_size": 32,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 64}


@pytest.mark.parametrize("key,value,words", [
    ("model_type", "roberta", "unsupported encoder model_type 'roberta'"),
    ("hidden_act", "gelu_new", "unsupported hidden_act 'gelu_new'"),
    ("position_embedding_type", "relative_key",
     "unsupported position_embedding_type 'relative_key'")])
def test_reader_refuses_what_the_jax_reader_refuses(key, value, words):
    for mod in (jck, tck):
        with pytest.raises(mod.CheckpointError) as err:
            mod.encoder_config_from_hf({**_BERT, key: value})
        assert words in str(err.value)


def test_reader_refuses_a_dtype_and_a_checkpoint_without_bert_tensors(
        transformers, tmp_path):
    path, _ = _tiny_bert_dir(transformers, tmp_path)
    cfg = tck.encoder_config_from_hf(tck.read_hf_config(path))
    with pytest.raises(tck.CheckpointError, match="unsupported dtype"):
        tck.load_hf_encoder_params(path, cfg, dtype="int8")
    from copilot_for_consensus_tpu_torch.checkpoint.safetensors import (
        save_file,
    )
    other = tmp_path / "other"
    other.mkdir()
    save_file({"x": torch.zeros(2)}, other / "model.safetensors")
    with pytest.raises(tck.CheckpointError, match="no BERT embedding"):
        tck.load_hf_encoder_params(other, cfg)
