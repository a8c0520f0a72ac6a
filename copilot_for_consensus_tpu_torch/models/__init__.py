"""Models: configs, int8 quantization, layers, the decoder and the
sentence encoder."""

from copilot_for_consensus_tpu_torch.models.configs import (
    DECODER_CONFIGS,
    ENCODER_CONFIGS,
    DecoderConfig,
    EncoderConfig,
    decoder_config,
    encoder_config,
)

__all__ = ["DECODER_CONFIGS", "ENCODER_CONFIGS", "DecoderConfig",
           "EncoderConfig", "decoder_config", "encoder_config"]
