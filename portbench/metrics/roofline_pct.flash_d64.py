"""``flash_attention``'s share of its roofline in V-JEPA 2's encoder: the
least time of its launches at the cell's ``[clips * heads, tokens,
head_dim]`` (``counts.flash_attention``, the larger of operations over the
bf16 peak and bytes over the memory's) over the device time of the trace's
``flash_bf16_kernel`` kernels."""
from portbench import counts, counts_vjepa2

KERNEL = "flash_bf16_kernel"


def read(h):
    s = h.trace_summary
    if s is None:
        return None
    n, seconds = s.launches(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    v = h.config["vjepa2"]
    clips = -(-h.cell["traffic"]["batch"] // v["frames_per_clip"])
    heads = v["num_attention_heads"]
    ops, nbytes = counts.flash_attention(clips * heads,
                                         counts_vjepa2.tokens(v),
                                         v["hidden_size"] // heads)
    return 100.0 * n * counts.roofline_s(ops, nbytes) / seconds
