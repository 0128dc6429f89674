"""The clip encoder's share of the card's bf16 peak: the frozen operations
of one clip's encode (``counts_vjepa2.clip_flops``) times the clips whose
codes reached the host in the traced window, over its seconds, over 989
TFLOP/s."""
from portbench import counts, counts_vjepa2


def read(h):
    s, clips = h.trace_summary, h.work.get("clips", 0)
    if s is None or not clips:
        return None
    flops = counts_vjepa2.clip_flops(h.config["vjepa2"])
    return 100.0 * flops * clips / s.window_s / counts.PEAK_BF16_FLOPS
