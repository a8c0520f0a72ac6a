"""HuggingFace checkpoint import: safetensors → decoder tree (port of the
JAX package's ``checkpoint/hf.py``, its decoder half).

Loads Mistral/Llama-family HF checkpoints into the port's stacked-layer
decoder tree, leaves as CPU ``torch`` tensors (``GenerationEngine
.from_checkpoint`` moves them to the card). The files are read by the
port's own ``checkpoint/safetensors.py``, not the ``safetensors``
package, and bfloat16 is torch's, not ``ml_dtypes``'.

Layout notes:
* torch ``nn.Linear`` stores ``[out, in]``; the decoder's matmuls are
  ``x @ W`` with ``W: [in, out]`` — every projection transposes on load.
* per-layer tensors stack on a leading ``n_layers`` axis, allocated once
  and filled layer by layer from lazily-read tensors.
* RoPE: both sides use the rotate-half convention, so q/k need no
  permutation.

Mixtral (MoE) checkpoints map to a config but do not load: the port has
no MoE decoder yet (ROADMAP Queue 1 item 6). The encoder half of the JAX
module (BERT/MiniLM) comes with the embedding encoder (item 2).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Callable

import torch

from copilot_for_consensus_tpu_torch.checkpoint.safetensors import (
    SafetensorsFile,
)
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig

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
    """Load an HF Mistral/Llama checkpoint as the decoder tree (CPU torch
    leaves; the caller moves them to the device or quantizes them)."""
    torch_dtype = _DTYPES.get(dtype)
    if torch_dtype is None:
        raise CheckpointError(f"unsupported dtype {dtype!r}")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a mixture-of-experts checkpoint "
            f"({cfg.n_experts} experts): the port has no MoE decoder yet "
            f"(ROADMAP Queue 1 item 6, models/moe.py)")
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
        "w_gate": stack("mlp.gate_proj", _t),
        "w_up": stack("mlp.up_proj", _t),
        "w_down": stack("mlp.down_proj", _t),
    }
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
