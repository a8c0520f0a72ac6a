"""Tools of the port that run on the card: the weight-stream probe
(``python -m copilot_for_consensus_tpu_torch.scripts.probe_stream``)."""
