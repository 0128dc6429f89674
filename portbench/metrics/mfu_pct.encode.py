"""The whole encode's share of the card's bf16 peak: the frozen operations
of one frame's encode (``counts.pixel_encode_flops``; the percep path adds
the SD encoder's, ``counts.sd_encode_flops``) times the frames that reached
the host in the traced window, over its seconds, over 989 TFLOP/s."""
from portbench import counts


def read(h):
    s, frames = h.trace_summary, h.work.get("frames", 0)
    if s is None or not frames:
        return None
    traffic, config = h.cell["traffic"], h.config
    per_frame = counts.pixel_encode_flops(config["model"])
    if traffic["path"] == "percep":
        sd = config["sd"]
        per_frame += counts.sd_encode_flops(sd, *traffic["sd_hw"])
    return 100.0 * per_frame * frames / s.window_s / counts.PEAK_BF16_FLOPS
