"""Decoder model: configs, int8 quantization, layers, decoder passes."""

from copilot_for_consensus_tpu_torch.models.configs import (
    DECODER_CONFIGS,
    DecoderConfig,
    decoder_config,
)

__all__ = ["DECODER_CONFIGS", "DecoderConfig", "decoder_config"]
