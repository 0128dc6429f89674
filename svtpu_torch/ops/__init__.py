"""Plain PyTorch ops and the hand-written kernels of the port (``csrc/``)."""
