"""The GroupNorm+SiLU kernel's share of its roofline in the SD encoder: the
least time of a batch's norms (``counts_group_norm.least_s``: each element
read and written once in the compute dtype, over the memory's peak), times
the batches that the trace's ``group_norm_silu_kernel`` launches make up
(one a norm), over the device time of the kernel's three launches a norm
(statistics, merge, apply). Nothing to read where the trace has none (a
program without the kernel)."""
from portbench import counts_group_norm

KERNELS = ("group_norm_silu_stats_kernel", "group_norm_silu_merge_kernel",
           "group_norm_silu_kernel")


def read(h):
    s = h.trace_summary
    if s is None or "sd" not in h.config:
        return None
    n, _ = s.launches(KERNELS[-1])
    seconds = sum(s.launches(k)[1] for k in KERNELS)
    if n == 0 or seconds <= 0:
        return None
    sd, traffic = h.config["sd"], h.cell["traffic"]
    hw = traffic["sd_hw"]
    per_batch = len(counts_group_norm.instances(sd, *hw))
    least = counts_group_norm.least_s(sd, *hw, traffic["batch"])
    return 100.0 * n / per_batch * least / seconds
