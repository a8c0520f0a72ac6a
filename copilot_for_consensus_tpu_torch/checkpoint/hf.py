"""HuggingFace checkpoint import: safetensors → decoder and encoder trees
(port of the JAX package's ``checkpoint/hf.py``).

Loads Mistral/Llama-family HF checkpoints into the port's stacked-layer
decoder tree, and BERT/MiniLM-family ones into the encoder tree, leaves as
CPU ``torch`` tensors (``GenerationEngine.from_checkpoint`` and
``EmbeddingEngine.from_checkpoint`` move them to the card). The files are read by the
port's own ``checkpoint/safetensors.py``, not the ``safetensors``
package, and bfloat16 is torch's, not ``ml_dtypes``'.

Layout notes:
* torch ``nn.Linear`` stores ``[out, in]``; the decoder's matmuls are
  ``x @ W`` with ``W: [in, out]`` — every projection transposes on load.
* per-layer tensors stack on a leading ``n_layers`` axis, allocated once
  and filled layer by layer from lazily-read tensors.
* RoPE: both sides use the rotate-half convention, so q/k need no
  permutation.

* Mixtral (MoE): ``block_sparse_moe.gate`` becomes the ``router``
  [L, D, E], kept in f32 whatever ``dtype`` is (routing flips experts near
  ties in bf16); ``experts.{j}.w1``/``w3``/``w2`` become ``w_gate``/
  ``w_up``/``w_down``, transposed and stacked [L, E, in, out].
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Callable

import torch

from copilot_for_consensus_tpu_torch.checkpoint.safetensors import (
    SafetensorsFile,
)
from copilot_for_consensus_tpu_torch.models.configs import (
    DecoderConfig,
    EncoderConfig,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class CheckpointError(RuntimeError):
    pass


def read_hf_config(path: str | pathlib.Path) -> dict:
    cfg_file = pathlib.Path(path) / "config.json"
    if not cfg_file.exists():
        raise CheckpointError(f"no config.json under {path}")
    return json.loads(cfg_file.read_text())


def config_from_hf(hf: dict) -> DecoderConfig:
    """Map an HF ``config.json`` to a :class:`DecoderConfig`."""
    model_type = hf.get("model_type", "")
    if model_type not in ("mistral", "llama", "mixtral"):
        raise CheckpointError(
            f"unsupported model_type {model_type!r} (mistral/llama/mixtral)")
    d_model = hf["hidden_size"]
    n_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or d_model // n_heads
    if head_dim != d_model // n_heads:
        raise CheckpointError(
            f"head_dim {head_dim} != hidden_size/num_heads "
            f"{d_model // n_heads}: decoupled head_dim is unsupported")
    scaling = hf.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) not in (
            None, "default"):
        # Silently dropping e.g. llama3 rope scaling would load fine and
        # garble every long-context forward — fail loudly instead.
        raise CheckpointError(
            f"rope_scaling {scaling!r} is unsupported (plain RoPE only)")
    return DecoderConfig(
        name=hf.get("_name_or_path") or model_type,
        vocab_size=hf["vocab_size"],
        d_model=d_model,
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        d_ff=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        max_seq_len=hf.get("max_position_embeddings", 32768),
        sliding_window=hf.get("sliding_window") or 0,
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        n_experts=hf.get("num_local_experts", 0),
        experts_per_token=hf.get("num_experts_per_tok", 2),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )


def _tensor_index(path: pathlib.Path) -> dict[str, pathlib.Path]:
    """tensor name → shard file, for single-file and sharded checkpoints."""
    index_file = path / "model.safetensors.index.json"
    if index_file.exists():
        index = json.loads(index_file.read_text())
        return {name: path / shard
                for name, shard in index["weight_map"].items()}
    single = path / "model.safetensors"
    if single.exists():
        return dict.fromkeys(SafetensorsFile(single).keys(), single)
    raise CheckpointError(f"no model.safetensors[.index.json] under {path}")


class _LazyReader:
    """Reads tensors by name across shard files, one mapping per shard
    (the header is parsed once a shard, not once a read)."""

    def __init__(self, path: pathlib.Path):
        self.index = _tensor_index(path)
        self._handles: dict[pathlib.Path, SafetensorsFile] = {}

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def get(self, name: str) -> torch.Tensor:
        shard = self.index.get(name)
        if shard is None:
            raise CheckpointError(f"tensor {name!r} missing from checkpoint")
        f = self._handles.get(shard)
        if f is None:
            f = self._handles[shard] = SafetensorsFile(shard)
        return f.get(name)


def _t(w: torch.Tensor) -> torch.Tensor:      # torch [out,in] → [in,out]
    return w.T


def _stacked(reader: _LazyReader, n_layers: int, dtype: torch.dtype,
             name_for: Callable[[int], str],
             transform: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
             ) -> torch.Tensor:
    """Allocate [n_layers, ...] once, fill with per-layer reads (each
    cast and laid out by one copy into its row)."""
    first = transform(reader.get(name_for(0)))
    out = torch.empty((n_layers,) + tuple(first.shape), dtype=dtype)
    out[0].copy_(first)
    for i in range(1, n_layers):
        out[i].copy_(transform(reader.get(name_for(i))))
    return out


def _cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``, contiguous, in one copy."""
    return torch.empty(w.shape, dtype=dtype).copy_(w)


def load_hf_params(path: str | pathlib.Path, cfg: DecoderConfig,
                   dtype: str = "bfloat16") -> dict[str, Any]:
    """Load an HF Mistral/Llama/Mixtral checkpoint as the decoder tree (CPU
    torch leaves; the caller moves them to the device or quantizes
    them)."""
    torch_dtype = _DTYPES.get(dtype)
    if torch_dtype is None:
        raise CheckpointError(f"unsupported dtype {dtype!r}")
    reader = _LazyReader(pathlib.Path(path))
    n = cfg.n_layers

    def lname(stem: str) -> Callable[[int], str]:
        return lambda i: f"model.layers.{i}.{stem}.weight"

    def stack(stem: str, transform=lambda x: x) -> torch.Tensor:
        return _stacked(reader, n, torch_dtype, lname(stem), transform)

    layer: dict[str, Any] = {
        "attn_norm": stack("input_layernorm"),
        "wq": stack("self_attn.q_proj", _t),
        "wk": stack("self_attn.k_proj", _t),
        "wv": stack("self_attn.v_proj", _t),
        "wo": stack("self_attn.o_proj", _t),
        "ffn_norm": stack("post_attention_layernorm"),
    }
    if cfg.is_moe:
        e = cfg.n_experts

        def expert_stack(w_name: str) -> torch.Tensor:
            # [n_layers, n_experts, in, out], one copy a (layer, expert)
            def name(i: int, j: int) -> str:
                return (f"model.layers.{i}.block_sparse_moe.experts.{j}."
                        f"{w_name}.weight")

            first = _t(reader.get(name(0, 0)))
            out = torch.empty((n, e) + tuple(first.shape),
                              dtype=torch_dtype)
            for i in range(n):
                for j in range(e):
                    out[i, j].copy_(_t(reader.get(name(i, j))))
            return out

        layer.update({
            # the router stays f32: routing is precision-sensitive
            "router": _stacked(reader, n, torch.float32,
                               lname("block_sparse_moe.gate"), _t),
            "w_gate": expert_stack("w1"),
            "w_up": expert_stack("w3"),
            "w_down": expert_stack("w2"),
        })
    else:
        layer.update({
            "w_gate": stack("mlp.gate_proj", _t),
            "w_up": stack("mlp.up_proj", _t),
            "w_down": stack("mlp.down_proj", _t),
        })
    params: dict[str, Any] = {
        "tok_emb": _cast(reader.get("model.embed_tokens.weight"),
                         torch_dtype),
        "layers": layer,
        "final_norm": _cast(reader.get("model.norm.weight"), torch_dtype),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in reader:
            params["lm_head"] = _cast(_t(reader.get("lm_head.weight")),
                                      torch_dtype)
        else:
            raise CheckpointError(
                "config says untied embeddings but lm_head.weight is "
                "missing from the checkpoint")
    return params


def load_hf_checkpoint(path: str | pathlib.Path, dtype: str = "bfloat16"
                       ) -> tuple[DecoderConfig, dict[str, Any]]:
    cfg = config_from_hf(read_hf_config(path))
    return cfg, load_hf_params(path, cfg, dtype)


# ---------------------------------------------------------------------------
# Encoder (BERT/MiniLM family) import — the weights behind the reference's
# default embedder all-MiniLM-L6-v2.
# ---------------------------------------------------------------------------


def encoder_config_from_hf(hf: dict) -> EncoderConfig:
    if hf.get("model_type") != "bert":
        raise CheckpointError(
            f"unsupported encoder model_type {hf.get('model_type')!r} "
            "(bert family only)")
    act = hf.get("hidden_act", "gelu")
    if act != "gelu":
        raise CheckpointError(f"unsupported hidden_act {act!r}")
    pos_type = hf.get("position_embedding_type", "absolute")
    if pos_type != "absolute":
        # a relative-position BERT loaded as absolute would serve wrong
        # vectors without a word
        raise CheckpointError(
            f"unsupported position_embedding_type {pos_type!r}")
    return EncoderConfig(
        name=hf.get("_name_or_path") or "bert",
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        d_ff=hf["intermediate_size"],
        max_positions=hf.get("max_position_embeddings", 512),
        norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
    )


def load_hf_encoder_params(path: str | pathlib.Path, cfg: EncoderConfig,
                           dtype: str = "float32") -> dict[str, Any]:
    """BERT-family safetensors → encoder tree (CPU torch leaves).
    Single-segment serving: the type-0 segment embedding is a constant
    addend at every position, so it folds into ``pos_emb`` (summed in
    f32) and token_type_ids disappear."""
    torch_dtype = _DTYPES.get(dtype)
    if torch_dtype is None:
        raise CheckpointError(f"unsupported dtype {dtype!r}")
    reader = _LazyReader(pathlib.Path(path))
    # BertModel saves bare names; BertFor* task models prefix "bert."
    prefix = "" if "embeddings.word_embeddings.weight" in reader else "bert."
    if f"{prefix}embeddings.word_embeddings.weight" not in reader:
        raise CheckpointError("no BERT embedding tensors in checkpoint")

    def g(name: str) -> torch.Tensor:
        return reader.get(prefix + name)

    def lname(stem: str, leaf: str = "weight") -> Callable[[int], str]:
        return lambda i: f"{prefix}encoder.layer.{i}.{stem}.{leaf}"

    def stack(stem: str, leaf: str = "weight",
              transform=lambda x: x) -> torch.Tensor:
        return _stacked(reader, cfg.n_layers, torch_dtype,
                        lname(stem, leaf), transform)

    pos = g("embeddings.position_embeddings.weight").float() \
        + g("embeddings.token_type_embeddings.weight")[0].float()
    return {
        "tok_emb": _cast(g("embeddings.word_embeddings.weight"),
                         torch_dtype),
        "pos_emb": _cast(pos, torch_dtype),
        "emb_norm_w": _cast(g("embeddings.LayerNorm.weight"), torch_dtype),
        "emb_norm_b": _cast(g("embeddings.LayerNorm.bias"), torch_dtype),
        "layers": {
            "wq": stack("attention.self.query", transform=_t),
            "wk": stack("attention.self.key", transform=_t),
            "wv": stack("attention.self.value", transform=_t),
            "wo": stack("attention.output.dense", transform=_t),
            "wq_b": stack("attention.self.query", "bias"),
            "wk_b": stack("attention.self.key", "bias"),
            "wv_b": stack("attention.self.value", "bias"),
            "wo_b": stack("attention.output.dense", "bias"),
            "attn_norm_w": stack("attention.output.LayerNorm"),
            "attn_norm_b": stack("attention.output.LayerNorm", "bias"),
            "w_in": stack("intermediate.dense", transform=_t),
            "b_in": stack("intermediate.dense", "bias"),
            "w_out": stack("output.dense", transform=_t),
            "b_out": stack("output.dense", "bias"),
            "ffn_norm_w": stack("output.LayerNorm"),
            "ffn_norm_b": stack("output.LayerNorm", "bias"),
        },
    }


def load_hf_encoder_checkpoint(path: str | pathlib.Path,
                               dtype: str = "float32"
                               ) -> tuple[EncoderConfig, dict[str, Any]]:
    cfg = encoder_config_from_hf(read_hf_config(path))
    return cfg, load_hf_encoder_params(path, cfg, dtype)
