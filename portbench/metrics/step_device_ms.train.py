"""Busy device time of the traced window (the union of the device's
intervals) over the train steps completed in it, in milliseconds."""


def read(h):
    s, steps = h.trace_summary, h.work.get("steps", 0)
    if s is None or not steps:
        return None
    return 1e3 * s.busy_s / steps
