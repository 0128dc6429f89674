"""``flash_attention``'s share of its roofline in the SD encoder's mid
block: the least time of its launches at the cell's ``[batch, tokens,
512]`` (``counts.flash_attention``, the larger of operations over the bf16
peak and bytes over the memory's) over the device time of the trace's
``flash_d512_kernel`` kernels."""
from portbench import counts

KERNEL = "flash_d512_kernel"


def read(h):
    s = h.trace_summary
    if s is None:
        return None
    n, seconds = s.launches(KERNEL)
    if n == 0 or seconds <= 0:
        return None
    sd, traffic = h.config["sd"], h.cell["traffic"]
    levels = len(sd["ch_mult"]) - 1
    tokens = (traffic["sd_hw"][0] >> levels) * (traffic["sd_hw"][1] >> levels)
    ops, nbytes = counts.flash_attention(traffic["batch"], tokens,
                                         sd["ch"] * sd["ch_mult"][-1])
    return 100.0 * n * counts.roofline_s(ops, nbytes) / seconds
