"""The global attention kernel's share of its roofline in SAM 2.1's
encoder: the least time of its launches at the cell's ``[frames x heads,
4096, 72]`` (``counts_sam2.attention_least_s`` over the global blocks, the
larger of operations over the bf16 peak and bytes over the memory's) over
the device time of the trace's ``flash_d72_kernel`` kernels."""
from portbench import counts_sam2

KERNEL = "flash_d72_kernel"


def read(h):
    s = h.trace_summary
    if s is None or "sam2" not in h.config:
        return None
    n, seconds = s.launches(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    cfg = h.config["sam2"]
    per_request = sum(g for *_, g in counts_sam2.attention_shapes(cfg))
    least = counts_sam2.attention_least_s(cfg, h.cell["traffic"]["batch"],
                                          True)
    return 100.0 * n / per_request * least / seconds
