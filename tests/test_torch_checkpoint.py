# The port's checkpoint reader and writer against the JAX package's, on the
# CPU at tiny widths: native checkpoints (int8, int4, unquantized) written
# by one package and read by the other bit for bit, HF-layout directories
# written here (no transformers needed) loaded to the same trees by both,
# the same refusals, engines from checkpoints whose greedy f32 streams equal
# the JAX engine's, and the checkpoint's tokenizer.
import dataclasses
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
from copilot_for_consensus_tpu.engine.tokenizer import (
    HFTokenizer as JaxHFTokenizer,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch import checkpoint as tck
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    save_byte_tokenizer,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4)
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def assert_trees_bit_equal(port_tree, jax_tree):
    a, b = _flat(port_tree), _flat(jax_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = _np(a[k]), _np(b[k])
        assert x.dtype.itemsize == y.dtype.itemsize, k
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _jax_tree(mode):
    jcfg = jax_config("tiny")
    tree = jax.tree.map(np.asarray, jdec.init_params(
        jax.random.PRNGKey(7), jcfg, dtype=jnp.float32))
    return jcfg, (jck.quantize_tree(tree, mode=mode) if mode else tree)


MODES = [False, "int8", "int4"]


@pytest.mark.parametrize("mode", MODES, ids=["plain", "int8", "int4"])
def test_port_reads_native_files_of_the_jax_package(mode, tmp_path):
    jcfg, tree = _jax_tree(mode)
    jck.save_native(tmp_path, jcfg, tree, eos_id=[2, 5])
    cfg, params, meta = tck.load_native(tmp_path)
    jcfg2, jparams, jmeta = jck.load_native(tmp_path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg2)
    assert meta == jmeta and meta["quantized"] == mode
    assert_trees_bit_equal(params, jparams)
    for leaf in ("q", "q4"):
        if f"layers/wq/{leaf}" in _flat(params):
            assert params["layers"]["wq"][leaf].dtype == torch.int8
            assert params["layers"]["wq"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("mode", MODES, ids=["plain", "int8", "int4"])
def test_jax_package_reads_native_files_of_the_port(mode, tmp_path):
    jcfg, tree = _jax_tree(mode)
    jck.save_native(tmp_path / "jax", jcfg, tree)
    cfg, params, _ = tck.load_native(tmp_path / "jax")
    # bf16 leaves too: the port writes torch's bfloat16 words
    params["final_norm"] = params["final_norm"].to(torch.bfloat16)
    tck.save_native(tmp_path / "port", cfg, params, bos_id=1, eos_id=2)
    jcfg2, jparams, jmeta = jck.load_native(tmp_path / "port")
    _, want, wmeta = jck.load_native(tmp_path / "jax")
    assert jparams["final_norm"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(
        jparams["final_norm"].astype(np.float32),
        np.asarray(want["final_norm"]).astype(ml_dtypes.bfloat16)
        .astype(np.float32))
    jparams["final_norm"] = want["final_norm"].astype(ml_dtypes.bfloat16)
    want["final_norm"] = jparams["final_norm"]
    assert_trees_bit_equal(jparams, want)
    assert jmeta == wmeta
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tree_equals_the_jax_package(mode):
    jcfg, tree = _jax_tree(False)
    want = jck.quantize_tree(tree, mode=mode)
    got = tck.quantize_tree(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree),
        mode=mode)
    assert_trees_bit_equal(got, want)


# -- HF-layout directories written here --------------------------------

HF_CONFIG = {
    "model_type": "mistral", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 128,
    "num_hidden_layers": 2, "vocab_size": 300,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "sliding_window": None, "bos_token_id": 1, "eos_token_id": 2,
}


def _hf_tensors(cfg: dict, dtype) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(3)
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    kv = d // cfg["num_attention_heads"] * cfg["num_key_value_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(dtype)

    out = {"model.embed_tokens.weight": w(v, d),
           "model.norm.weight": (1 + w(d)).astype(dtype),
           "lm_head.weight": w(v, d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (1 + w(d)).astype(dtype),
            p + "post_attention_layernorm.weight": (1 + w(d)).astype(dtype),
            p + "self_attn.q_proj.weight": w(d, d),
            p + "self_attn.k_proj.weight": w(kv, d),
            p + "self_attn.v_proj.weight": w(kv, d),
            p + "self_attn.o_proj.weight": w(d, d),
            p + "mlp.gate_proj.weight": w(f, d),
            p + "mlp.up_proj.weight": w(f, d),
            p + "mlp.down_proj.weight": w(d, f)})
    return out


def write_hf_dir(path, *, dtype=np.float32, sharded=False, **overrides):
    path.mkdir(parents=True, exist_ok=True)
    cfg = {**HF_CONFIG, **overrides}
    (path / "config.json").write_text(json.dumps(cfg))
    tensors = _hf_tensors(cfg, dtype)
    if not sharded:
        st_save(tensors, str(path / "model.safetensors"))
        return path
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    weight_map = {}
    for shard, keys in shards.items():
        st_save({k: tensors[k] for k in keys}, str(path / shard))
        weight_map.update(dict.fromkeys(keys, shard))
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    return path


@pytest.mark.parametrize("file_dtype,dtype,sharded", [
    (np.float32, "float32", False), (np.float32, "bfloat16", False),
    (ml_dtypes.bfloat16, "bfloat16", False),
    (ml_dtypes.bfloat16, "float32", True)],
    ids=["f32-f32", "f32-bf16", "bf16-bf16", "bf16-f32-sharded"])
def test_hf_trees_equal_the_jax_package(file_dtype, dtype, sharded,
                                        tmp_path):
    path = write_hf_dir(tmp_path, dtype=file_dtype, sharded=sharded)
    cfg, params = tck.load_hf_checkpoint(path, dtype)
    jcfg, jparams = jck.load_hf_checkpoint(path, dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_trees_bit_equal(params, jparams)
    assert not tck.is_native(path)
    _, _, meta = tck.load_checkpoint(path, dtype)
    assert meta == jck.load_checkpoint(path, dtype)[2]


@pytest.mark.parametrize("hf", [
    HF_CONFIG,
    {**HF_CONFIG, "model_type": "llama", "num_key_value_heads": 4,
     "rope_theta": 500000.0, "rms_norm_eps": 1e-6,
     "rope_scaling": {"rope_type": "default"},
     "_name_or_path": "meta-llama/tiny", "tie_word_embeddings": True},
    {**HF_CONFIG, "model_type": "mixtral", "num_local_experts": 4,
     "num_experts_per_tok": 2, "sliding_window": 4096}],
    ids=["mistral", "llama", "mixtral"])
def test_config_from_hf_equals_the_jax_package(hf):
    assert dataclasses.asdict(tck.config_from_hf(hf)) == \
        dataclasses.asdict(jck.config_from_hf(hf))


@pytest.mark.parametrize("hf,match", [
    ({**HF_CONFIG, "rope_scaling": {"rope_type": "llama3",
                                    "factor": 8.0}}, "rope_scaling"),
    ({**HF_CONFIG, "model_type": "gpt2"}, "unsupported model_type"),
    ({**HF_CONFIG, "head_dim": 32}, "decoupled head_dim")],
    ids=["rope_scaling", "model_type", "head_dim"])
def test_config_refusals_match_the_jax_package(hf, match):
    with pytest.raises(tck.CheckpointError, match=match):
        tck.config_from_hf(hf)
    with pytest.raises(jck.CheckpointError, match=match):
        jck.config_from_hf(hf)


def test_moe_checkpoints_are_refused_naming_the_roadmap_item(tmp_path):
    path = write_hf_dir(tmp_path, model_type="mixtral",
                        num_local_experts=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tck.load_hf_checkpoint(path, "float32")


def test_missing_lm_head_and_files_are_refused(tmp_path):
    path = write_hf_dir(tmp_path / "a")
    tensors = tck.safetensors.load_file(path / "model.safetensors")
    del tensors["lm_head.weight"]
    tck.safetensors.save_file(tensors, path / "model.safetensors")
    with pytest.raises(tck.CheckpointError, match="lm_head"):
        tck.load_hf_checkpoint(path, "float32")
    with pytest.raises(tck.CheckpointError, match="config.json"):
        tck.load_hf_checkpoint(tmp_path / "none", "float32")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "config.json").write_text(json.dumps(HF_CONFIG))
    with pytest.raises(tck.CheckpointError, match="model.safetensors"):
        tck.load_hf_checkpoint(tmp_path / "b", "float32")


@pytest.mark.parametrize("quantize", [True, "int4"], ids=["int8", "int4"])
def test_convert_equals_the_jax_package(quantize, tmp_path):
    src = write_hf_dir(tmp_path / "hf", dtype=ml_dtypes.bfloat16)
    save_byte_tokenizer(src)
    meta = tck.convert(src, tmp_path / "port", quantize=quantize)
    jmeta = jck.convert(src, tmp_path / "jax", quantize=quantize)
    assert meta == jmeta
    assert (tmp_path / "port" / "tokenizer.json").read_bytes() == \
        (src / "tokenizer.json").read_bytes()
    _, got, _ = tck.load_native(tmp_path / "port")
    _, want, _ = jck.load_native(tmp_path / "jax")
    assert_trees_bit_equal(got, want)


# -- engines from checkpoints: greedy f32 streams equal the JAX engine's --

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_from_checkpoint_streams_equal_jax(mode, tmp_path):
    jcfg, tree = _jax_tree(mode)
    jck.save_native(tmp_path, jcfg, tree)
    jeng = JaxEngine.from_checkpoint(str(tmp_path), dtype=jnp.float32,
                                     telemetry=False, **ENGINE_KW)
    teng = GenerationEngine.from_checkpoint(tmp_path, dtype=torch.float32,
                                            device="cpu", **ENGINE_KW)
    assert teng.quant_mode == mode and teng.dtype == torch.float32
    assert teng.eos_id == jeng.eos_id
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert sum(len(g.tokens) for g in got) > 2 * len(PROMPTS)


def test_from_hf_checkpoint_streams_equal_jax(tmp_path):
    # a wrong transpose or head order still loads: only the streams show it
    path = write_hf_dir(tmp_path, eos_token_id=[2, 7])
    jeng = JaxEngine.from_checkpoint(str(path), dtype=jnp.float32,
                                     telemetry=False, **ENGINE_KW)
    teng = GenerationEngine.from_checkpoint(path, dtype="float32",
                                            device="cpu", **ENGINE_KW)
    assert teng.quant_mode is None and teng._eos_set == {2, 7}
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_from_checkpoint_leaves_follow_the_bridge_rules(tmp_path):
    jcfg, tree = _jax_tree("int4")
    jck.save_native(tmp_path, jcfg, tree)
    eng = GenerationEngine.from_checkpoint(tmp_path, device="cpu")
    layers = eng.params["layers"]
    assert eng.dtype == torch.bfloat16
    assert layers["wqkv"]["q4"].dtype == torch.int8     # fused int4 leaves
    assert layers["wqkv"]["scale"].dtype == torch.float32
    assert layers["attn_norm"].dtype == torch.bfloat16
    assert eng.params["tok_emb"].dtype == torch.bfloat16


def test_from_checkpoint_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tree = _jax_tree("int8")
    jck.save_native(tmp_path, jcfg, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine.from_checkpoint(tmp_path)


# -- tokenizer and summarizer ------------------------------------------

def test_load_tokenizer_round_trips_like_the_jax_hftokenizer(
        tmp_path, fixtures_dir):
    jcfg, tree = _jax_tree("int8")
    jck.save_native(tmp_path, jcfg, tree, bos_id=1, eos_id=[2, 9])
    save_byte_tokenizer(tmp_path)
    text = (fixtures_dir / "ietf-sample.mbox").read_text()
    tok = tck.load_tokenizer(tmp_path)
    jtok = jck.load_tokenizer(tmp_path)
    assert isinstance(jtok, JaxHFTokenizer)
    ids = tok.encode(text, add_bos=True, add_eos=True)
    assert ids == jtok.encode(text, add_bos=True, add_eos=True)
    assert ids[1:-1] == ByteTokenizer().encode(text)
    assert tok.decode(ids) == jtok.decode(ids) == text
    assert (tok.bos_id, tok.eos_ids) == (jtok.bos_id, jtok.eos_ids) \
        == (1, (2, 9))
    assert tck.load_tokenizer(tmp_path / "absent") is None


def test_summarizer_from_checkpoint(tmp_path):
    jcfg, tree = _jax_tree("int8")
    jck.save_native(tmp_path, jcfg, tree)
    with pytest.raises(ValueError, match="no tokenizer.json"):
        CUDASummarizer(checkpoint=str(tmp_path), device="cpu")
    summ = CUDASummarizer(checkpoint=str(tmp_path), device="cpu",
                          tokenizer=ByteTokenizer(512), max_new_tokens=4)
    assert summ._model == f"checkpoint:{tmp_path}"
    assert summ.engine.quant_mode == "int8"
    save_byte_tokenizer(tmp_path)
    summ = CUDASummarizer(checkpoint=str(tmp_path), device="cpu",
                          max_new_tokens=4, num_slots=2, max_len=256)
    assert summ.engine.num_slots == 2 and summ.engine.max_len == 256
    assert summ.tokenizer.vocab_size == 259


def test_config_dataclasses_share_their_fields():
    # meta.json carries dataclasses.asdict(cfg): both packages' configs
    # must take each other's fields
    assert [f.name for f in dataclasses.fields(DecoderConfig)] == \
        [f.name for f in dataclasses.fields(type(jax_config("tiny")))]
