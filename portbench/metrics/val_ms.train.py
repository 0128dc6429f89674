"""The trainer's val step at the epoch boundary (the ``svtpu.train.val``
spans: the val batches and their readback) in the traced window, over the
train steps completed in it, in milliseconds."""
from portbench import spans


def read(h):
    return spans.per_step_ms(h, "svtpu.train.val")
