"""Checkpoints: HF import and the native serving format (port of the JAX
package's ``checkpoint/``), read and written without ``safetensors`` or
``ml_dtypes`` (``checkpoint/safetensors.py``). ``bridge.py`` is the tests'
bridge from the JAX package's in-memory trees. The training-state
checkpointer comes with training (ROADMAP Queue 1 item 6)."""

from copilot_for_consensus_tpu_torch.checkpoint.hf import (
    CheckpointError,
    config_from_hf,
    encoder_config_from_hf,
    load_hf_checkpoint,
    load_hf_encoder_checkpoint,
    load_hf_encoder_params,
    load_hf_params,
    read_hf_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    FORMAT,
    convert,
    is_native,
    load_checkpoint,
    load_native,
    load_tokenizer,
    quantize_tree,
    save_native,
)

__all__ = [
    "CheckpointError", "FORMAT", "config_from_hf", "convert",
    "encoder_config_from_hf", "is_native", "load_checkpoint",
    "load_hf_checkpoint", "load_hf_encoder_checkpoint",
    "load_hf_encoder_params", "load_hf_params", "load_native",
    "load_tokenizer", "quantize_tree", "read_hf_config", "save_native",
]
