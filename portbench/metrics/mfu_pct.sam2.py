"""SAM 2.1's image encoder's share of the card's bf16 peak: the frozen
operations of one frame's encode (``counts_sam2.frame_flops``) times the
frames whose codes reached the host in the traced window, over its
seconds, over 989 TFLOP/s."""
from portbench import counts, counts_sam2


def read(h):
    s, frames = h.trace_summary, h.work.get("frames", 0)
    if s is None or not frames or "sam2" not in h.config:
        return None
    flops = counts_sam2.frame_flops(h.config["sam2"])
    return 100.0 * flops * frames / s.window_s / counts.PEAK_BF16_FLOPS
