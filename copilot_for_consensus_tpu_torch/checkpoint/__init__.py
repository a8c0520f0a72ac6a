"""Weights from outside the port (``bridge.params_from_numpy``)."""
