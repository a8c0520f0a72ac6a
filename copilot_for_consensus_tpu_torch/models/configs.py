"""Decoder configuration registry (the port's own copy).

Copied from the JAX package's ``models/configs.py`` — the port imports
nothing of that package. Holds the serving target of this slice
(``mistral-7b``) and the two test-scale models that keep its code path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DecoderConfig:
    name: str = "decoder"
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 10000.0
    max_seq_len: int = 32768
    sliding_window: int = 0          # 0 = full causal attention
    norm_eps: float = 1e-5
    # MoE (0 experts = dense FFN)
    n_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    tie_embeddings: bool = False
    #: explicit per-head width; 0 derives d_model // n_heads
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


DECODER_CONFIGS: dict[str, DecoderConfig] = {
    # Mistral-7B class: GQA 32/8, SWA 4096.
    "mistral-7b": DecoderConfig(
        name="mistral-7b", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=1e6,
        max_seq_len=32768, sliding_window=4096,
    ),
    # Test-scale models: same code path, tiny widths.
    "tiny": DecoderConfig(
        name="tiny", vocab_size=512, d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=256, max_seq_len=512, sliding_window=0,
    ),
    "tiny-swa": DecoderConfig(
        name="tiny-swa", vocab_size=512, d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=256, max_seq_len=512, sliding_window=64,
    ),
}


def decoder_config(name: str, **overrides) -> DecoderConfig:
    cfg = DECODER_CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
