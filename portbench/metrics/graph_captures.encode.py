"""CUDA graph captures (the ``svtpu.graph.capture`` spans) that started in
the traced window of an encode cell."""
from portbench import spans


def read(h):
    return spans.captures(h)
