"""Native serving checkpoints: mapped safetensors + config metadata (port
of the JAX package's ``checkpoint/native.py``).

A native checkpoint directory holds:

* ``model.safetensors`` — the decoder tree flattened with ``/``-joined
  keys. Quantized leaves appear as ``<path>/q`` (int8) or ``<path>/q4``
  (packed int4) beside ``<path>/scale`` (f32).
* ``meta.json`` — the ``DecoderConfig`` fields, the format marker, the
  quantization mode and the tokenizer's special ids.
* ``tokenizer.json`` — optional; copied from the source HF checkpoint so
  serving needs exactly one directory.

The files are the JAX package's, byte for byte in what they hold: either
package reads what the other wrote. The port reads and writes them with
its own ``checkpoint/safetensors.py`` (no ``safetensors``, no
``ml_dtypes``), and its leaves are CPU ``torch`` tensors over the mapped
file; ``GenerationEngine.from_checkpoint`` moves them to the card.
Offline quantization (``convert``, ``quantize_tree``) runs on the host
with the port's ``models/quant.py`` functions, the same arithmetic as the
JAX package's numpy mirrors of them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
from typing import Any

from copilot_for_consensus_tpu_torch.checkpoint.hf import (
    CheckpointError,
    load_hf_checkpoint,
)
from copilot_for_consensus_tpu_torch.checkpoint.safetensors import (
    load_file,
    save_file,
)
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import (
    DECODER_QUANT_LEAVES,
    quantize_tensor,
    quantize_tensor_int4,
)

FORMAT = "copilot-tpu-native-v1"


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def quantize_tree(params: dict,
                  leaves: tuple[tuple[str, ...], ...] = DECODER_QUANT_LEAVES,
                  mode: str = "int8") -> dict:
    """Quantize the given leaves of a tree of CPU tensors (int8
    per-channel or int4 group-wise packed); other leaves pass through."""
    out = {k: (quantize_tree(v, tuple(
        rest[1:] for rest in leaves if rest and rest[0] == k), mode)
        if isinstance(v, dict) else v) for k, v in params.items()}
    for path in leaves:
        if len(path) == 1 and path[0] in params and not isinstance(
                params[path[0]], dict):
            w = params[path[0]]
            out[path[0]] = (quantize_tensor(w) if mode == "int8"
                            else quantize_tensor_int4(w))
    return out


def _norm_token_id(value, default: int) -> tuple[int, list[int]]:
    """HF configs may carry an int or a list (Llama-3.1 multi-EOS).
    Returns (primary, all)."""
    if isinstance(value, (list, tuple)) and value:
        ids = [int(v) for v in value]
        return ids[0], ids
    if value is None:
        return default, [default]
    return int(value), [int(value)]


def save_native(path: str | pathlib.Path, cfg: DecoderConfig, params: dict,
                *, tokenizer_file: str | pathlib.Path | None = None,
                bos_id=None, eos_id=None) -> int:
    """Write ``params`` (torch tensors on any device) as a native
    checkpoint; returns the bytes of ``model.safetensors``."""
    out = pathlib.Path(path)
    out.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    nbytes = save_file(flat, out / "model.safetensors")
    bos, _ = _norm_token_id(bos_id, 1)
    eos, eos_ids = _norm_token_id(eos_id, 2)
    meta = {
        "format": FORMAT,
        "config": dataclasses.asdict(cfg),
        # "int8" / "int4" / False — engines pass this straight through
        # as the quantize mode (older checkpoints stored a bool; True
        # meant int8 and still does).
        "quantized": ("int4" if any(k.endswith("/q4") for k in flat)
                      else "int8" if any(k.endswith("/q") for k in flat)
                      else False),
        "bos_id": bos,
        "eos_id": eos,
        "eos_ids": eos_ids,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    if tokenizer_file is not None and pathlib.Path(tokenizer_file).exists():
        shutil.copy(tokenizer_file, out / "tokenizer.json")
    return nbytes


def is_native(path: str | pathlib.Path) -> bool:
    meta = pathlib.Path(path) / "meta.json"
    if not meta.exists():
        return False
    try:
        return json.loads(meta.read_text()).get("format") == FORMAT
    except (json.JSONDecodeError, OSError):
        return False


def load_native(path: str | pathlib.Path
                ) -> tuple[DecoderConfig, dict, dict]:
    """Returns (cfg, params, meta). Leaves are CPU tensors over the mapped
    file; the caller moves them to the device."""
    p = pathlib.Path(path)
    meta = json.loads((p / "meta.json").read_text())
    if meta.get("format") != FORMAT:
        raise CheckpointError(f"{path} is not a {FORMAT} checkpoint")
    cfg = DecoderConfig(**meta["config"])
    params = _unflatten(load_file(p / "model.safetensors"))
    return cfg, params, meta


def load_checkpoint(path: str | pathlib.Path, dtype: str = "bfloat16"
                    ) -> tuple[DecoderConfig, dict, dict]:
    """Auto-detect: native dir → as saved; HF dir → converted in memory
    (to ``dtype``). Returns (cfg, params, meta) with CPU tensor leaves."""
    p = pathlib.Path(path)
    if is_native(p):
        return load_native(p)
    cfg, params = load_hf_checkpoint(p, dtype)
    hf_cfg = json.loads((p / "config.json").read_text())
    bos, _ = _norm_token_id(hf_cfg.get("bos_token_id"), 1)
    eos, eos_ids = _norm_token_id(hf_cfg.get("eos_token_id"), 2)
    meta = {
        "format": "hf", "quantized": False,
        "bos_id": bos, "eos_id": eos, "eos_ids": eos_ids,
    }
    return cfg, params, meta


def convert(src: str | pathlib.Path, dst: str | pathlib.Path, *,
            quantize: bool | str = True, dtype: str = "bfloat16") -> dict:
    """Offline converter: HF checkpoint → native serving checkpoint.
    ``quantize``: False | True/"int8" | "int4". Returns the written meta
    dict."""
    src, dst = pathlib.Path(src), pathlib.Path(dst)
    cfg, params = load_hf_checkpoint(src, dtype)
    if quantize:
        params = quantize_tree(
            params, mode="int8" if quantize is True else quantize)
    hf_cfg = json.loads((src / "config.json").read_text())
    # Raw values straight through — save_native's _norm_token_id handles
    # None and list forms; coalescing here would corrupt a real id 0.
    save_native(
        dst, cfg, params,
        tokenizer_file=src / "tokenizer.json",
        bos_id=hf_cfg.get("bos_token_id"),
        eos_id=hf_cfg.get("eos_token_id"))
    return json.loads((dst / "meta.json").read_text())


def load_tokenizer(path: str | pathlib.Path):
    """HFTokenizer from a checkpoint dir's ``tokenizer.json``, with
    bos/eos ids taken from the checkpoint metadata. None if absent."""
    from copilot_for_consensus_tpu_torch.engine.tokenizer import HFTokenizer

    p = pathlib.Path(path)
    tok_file = p / "tokenizer.json"
    if not tok_file.exists():
        return None
    bos, eos = 1, [2]
    meta_file = p / "meta.json"
    cfg_file = p / "config.json"
    if meta_file.exists():
        meta = json.loads(meta_file.read_text())
        bos = meta.get("bos_id", 1)
        eos = meta.get("eos_ids") or [meta.get("eos_id", 2)]
    elif cfg_file.exists():
        hf = json.loads(cfg_file.read_text())
        bos, _ = _norm_token_id(hf.get("bos_token_id"), 1)
        _, eos = _norm_token_id(hf.get("eos_token_id"), 2)
    return HFTokenizer(str(tok_file), bos_id=bos, eos_id=eos)


def save_byte_tokenizer(path: str | pathlib.Path) -> pathlib.Path:
    """Write ``tokenizer.json`` into the checkpoint dir ``path``: a
    byte-level BPE with no merges whose ids are ``ByteTokenizer``'s (the
    specials 0-2, byte ``b`` at ``b + 3``), for a checkpoint of weights
    that were not trained with a vocabulary of their own (random weights
    from a seed). Needs the ``tokenizers`` package, as reading it does."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from copilot_for_consensus_tpu_torch.engine.tokenizer import N_SPECIALS

    # GPT-2's byte → printable character map, which ByteLevel applies
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    chars, extra = {}, 0
    for b in range(256):
        if b in printable:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}
    vocab.update({chars[b]: b + N_SPECIALS for b in range(256)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                 use_regex=False)
    tok.decoder = decoders.ByteLevel()
    out = pathlib.Path(path) / "tokenizer.json"
    tok.save(str(out))
    return out
