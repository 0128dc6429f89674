"""The windowed attention kernel's share of its roofline in SAM 2.1's
encoder: the least time of a request's windowed and query-pooled
attention (``counts_sam2.attention_least_s``, each of the cell's shapes
the larger of operations over the bf16 peak and bytes over the memory's,
summed over the blocks), times the requests its launches make up, over
the device time of the trace's ``window_attn_kernel`` kernels."""
from portbench import counts_sam2

KERNEL = "window_attn_kernel"


def read(h):
    s = h.trace_summary
    if s is None or "sam2" not in h.config:
        return None
    n, seconds = s.launches(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    cfg = h.config["sam2"]
    per_request = sum(not g for *_, g in counts_sam2.attention_shapes(cfg))
    least = counts_sam2.attention_least_s(cfg, h.cell["traffic"]["batch"],
                                          False)
    return 100.0 * n / per_request * least / seconds
