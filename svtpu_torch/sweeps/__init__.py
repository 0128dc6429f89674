"""Hyperparameter sweeps: the spaces and the runner (the port of
``svtpu/sweeps``)."""
