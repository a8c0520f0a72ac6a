"""Chunker driver registration."""

from copilot_for_consensus_tpu_torch.core.factory import register_driver

for _name in ("token_window", "fixed_size", "semantic"):
    register_driver("chunker", _name,
                    "copilot_for_consensus_tpu_torch.text.chunkers:create_chunker")
