"""CUDA graph captures (the ``svtpu.graph.capture`` spans, step and probe
graphs alike) that started in the traced window of a train cell."""
from portbench import spans


def read(h):
    return spans.captures(h)
