"""Observability: the port's copy of the JAX package's structured logger."""
