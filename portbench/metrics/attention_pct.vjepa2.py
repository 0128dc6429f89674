"""The attention kernel's share of the card's busy time in the clip cell:
the union of the trace's ``flash_bf16_kernel`` intervals (``flash_attention``
at D = 64) over the union of all device intervals in the traced window."""

KERNEL = "flash_bf16_kernel"


def read(h):
    s = h.trace_summary
    if s is None or s.busy_s <= 0:
        return None
    share = s.share(lambda label, cat, full: cat == "kernel"
                    and label.rsplit("::", 1)[-1] == KERNEL)
    if share <= 0:
        return None
    return 100.0 * share * s.window_s / s.busy_s
