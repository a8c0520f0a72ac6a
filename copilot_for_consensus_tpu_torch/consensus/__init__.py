"""Consensus detection (reference: ``adapters/copilot_consensus``)."""

from copilot_for_consensus_tpu_torch.consensus.base import (
    ConsensusDetector,
    ConsensusLevel,
    ConsensusSignal,
    HeuristicConsensusDetector,
    MockConsensusDetector,
    create_consensus_detector,
)

__all__ = [
    "ConsensusDetector",
    "ConsensusLevel",
    "ConsensusSignal",
    "HeuristicConsensusDetector",
    "MockConsensusDetector",
    "create_consensus_detector",
]
