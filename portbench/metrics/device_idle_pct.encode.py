"""Share of the traced window in which no operation ran on the card (100
less the union of the device's kernel, copy and fill intervals), encode
cells."""


def read(h):
    s = h.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
