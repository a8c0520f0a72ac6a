"""Serving engine: continuous batching, sampling, tokenizers."""
