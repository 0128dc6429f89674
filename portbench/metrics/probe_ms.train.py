"""The trainer's probes at the epoch boundary (the ``svtpu.train.probe``
spans: ``state_consistency`` and ``state_separation``) in the traced
window, over the train steps completed in it, in milliseconds."""
from portbench import spans


def read(h):
    return spans.per_step_ms(h, "svtpu.train.probe")
