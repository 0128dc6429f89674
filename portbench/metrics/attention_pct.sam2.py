"""The D = 72 attention kernels' share of the card's busy time in the
SAM 2 cell: the union of the trace's ``window_attn_kernel`` (windowed and
query-pooled blocks) and ``flash_d72_kernel`` (global blocks) intervals
over the union of all device intervals in the traced window."""

KERNELS = ("window_attn_kernel", "flash_d72_kernel")


def read(h):
    s = h.trace_summary
    if s is None or s.busy_s <= 0:
        return None
    share = s.share(lambda label, cat, full: cat == "kernel"
                    and label.rsplit("::", 1)[-1] in KERNELS)
    if share <= 0:
        return None
    return 100.0 * share * s.window_s / s.busy_s
