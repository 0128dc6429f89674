"""``fused_conv01``'s share of its roofline: the least time of its launches
at the cell's batch (``counts.fused_conv01``, the larger of operations over
the bf16 peak and bytes over the memory's) over the device time of the
trace's ``fused_conv01_tc`` kernels."""
from portbench import counts

KERNEL = "fused_conv01_tc"


def read(h):
    s = h.trace_summary
    if s is None:
        return None
    n, seconds = s.launches(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    ops, nbytes = counts.fused_conv01(h.config["model"],
                                      h.cell["traffic"]["batch"])
    return 100.0 * n * counts.roofline_s(ops, nbytes) / seconds
