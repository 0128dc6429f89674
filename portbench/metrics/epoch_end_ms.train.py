"""The trainer's epoch boundary (the ``svtpu.train.epoch_end`` spans: the
val step, the probes, the metrics writer, selection) in the traced window,
over the train steps completed in it, in milliseconds."""
from portbench import spans


def read(h):
    return spans.per_step_ms(h, "svtpu.train.epoch_end")
