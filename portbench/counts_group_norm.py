"""Elements and least time of the SD encoder's GroupNorm(+SiLU) layers,
counted from its shapes (``configs/sd-v1-percep.json``'s ``sd``), as
``counts.py`` counts the other kernels' work: each element read once and
written once in the compute dtype, over the memory's peak. Frozen here so
that a change to the program cannot move its own yardstick."""
from __future__ import annotations

from portbench import counts

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def instances(sd: dict, h: int, w: int) -> list[tuple[int, int]]:
    """Each norm of the encoder on one ``h`` x ``w`` frame, in order, as
    ``(channels, pixels)``: two a ResnetBlock at every level (the first
    over the block's input channels), the mid block's two ResnetBlocks and
    its attention's norm, and ``norm_out``."""
    ch, mult = sd["ch"], sd["ch_mult"]
    out = []
    c_in = ch
    for lvl, m in enumerate(mult):
        for _ in range(sd["num_res_blocks"]):
            out += [(c_in, h * w), (ch * m, h * w)]
            c_in = ch * m
        if lvl != len(mult) - 1:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1        # pad (0,1,0,1)
    return out + [(c_in, h * w)] * 6


def elements(sd: dict, h: int, w: int) -> int:
    """The elements the encoder's norms take on one frame."""
    return sum(c * px for c, px in instances(sd, h, w))


def least_s(sd: dict, h: int, w: int, batch: int) -> float:
    """The least time of a batch's norms: one read and one write of every
    element in the compute dtype over 3.35 TB/s."""
    nbytes = 2 * ITEMSIZE[sd["compute_dtype"]] * batch * elements(sd, h, w)
    return counts.roofline_s(0.0, nbytes)
