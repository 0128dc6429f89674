"""The whole train step's share of the cards' bf16 peak: the frozen FLOPs
of a step (``counts.train_step_flops`` of its ``2 B S`` frames) times the
steps completed in the traced window, over its seconds, over 989 TFLOP/s
times the cell's cards."""
from portbench import counts


def read(h):
    s, steps = h.trace_summary, h.work.get("steps", 0)
    if s is None or not steps:
        return None
    t = h.config["train"]
    frames = 2 * t["batch_size"] * (len(h.config["video"]["flags"]) + 1)
    flops = counts.train_step_flops(h.config["model"], frames)
    return 100.0 * flops * steps / s.window_s / (
        counts.PEAK_BF16_FLOPS * h.chips)
