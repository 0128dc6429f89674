"""Operations and bytes of SAM 2.1's image encoder on one frame, counted
from its shapes (``configs/sam2.1-hiera-large.json``), as ``counts.py``
counts the other cells' work: a multiply-add counts two operations; an
attention's bytes are its bf16 q, k, v read and its output written once.
Frozen here so that a change to the program cannot move its own
yardstick."""
from __future__ import annotations

from portbench import counts
from portbench.reference import sam2 as refs


def blocks(cfg: dict) -> list:
    """Each block's ``(grid side, dim_in, dim_out, heads, window,
    pooled)``: the reference's blocks (``reference/sam2.blocks``) with the
    side of the token grid each one reads, halved after each pooled
    block."""
    side = cfg["image_size"] // cfg["patch_stride"]
    out = []
    for spec in refs.blocks(cfg):
        out.append((side,) + spec)
        if spec[-1]:
            side //= 2
    return out


def attention_shapes(cfg: dict) -> list:
    """Each block's attention as ``(windows x heads, Nq, Nk, head_dim,
    global)`` on one frame."""
    out = []
    for side, _, dout, heads, window, pooled in blocks(cfg):
        w = window or side
        nk = w * w
        nq = nk // 4 if pooled else nk
        out.append(((side // w) ** 2 * heads, nq, nk, dout // heads,
                    window == 0))
    return out


def attention(b: int, nq: int, nk: int, d: int) -> tuple[float, float]:
    """Attention of ``b`` windows-heads, ``nq`` queries over ``nk`` keys of
    width ``d``: (operations, bytes)."""
    return 4.0 * b * nq * nk * d, float(2 * b * d * (2 * nq + 2 * nk))


def frame_macs(cfg: dict) -> dict:
    """Multiply-adds of one frame by part: the patch embed; the blocks'
    products (qkv, proj, the stage changes' residual projection, the MLP);
    attention's two products; the neck's two 1x1 convs that make the 64x64
    level (the 256² and 128² laterals are not run). Norms, GELU, the
    pools and the position embedding are not counted."""
    side = cfg["image_size"] // cfg["patch_stride"]
    k = cfg["patch_kernel_size"]
    C0 = cfg["embed_dim_per_stage"][0]
    embed = side * side * cfg["num_channels"] * k * k * C0
    gemms = 0
    for s, din, dout, _, _, pooled in blocks(cfg):
        t_in = s * s
        t_out = t_in // 4 if pooled else t_in
        M = int(dout * cfg["mlp_ratio"])
        gemms += t_in * din * 3 * dout + t_out * dout * dout \
            + 2 * t_out * dout * M
        if din != dout:
            gemms += t_in * din * dout
    attn = sum(b * nq * nk * d * 2
               for b, nq, nk, d, _ in attention_shapes(cfg))
    chans, fpn = cfg["backbone_channel_list"], cfg["fpn_hidden_size"]
    s3 = side // 4
    neck = (s3 // 2) ** 2 * chans[0] * fpn + s3 * s3 * chans[1] * fpn
    return {"embed": embed, "gemms": gemms, "attention": attn, "neck": neck}


def frame_flops(cfg: dict) -> float:
    """Operations of one frame's encode."""
    return 2.0 * sum(frame_macs(cfg).values())


def attention_least_s(cfg: dict, frames: int, global_: bool) -> float:
    """The least time of ``frames`` frames' windowed and query-pooled
    attention (``global_`` False) or global attention (True): each shape's
    larger of operations over the bf16 peak and bytes over the memory's,
    summed over the blocks."""
    return sum(counts.roofline_s(*attention(frames * b, nq, nk, d))
               for b, nq, nk, d, g in attention_shapes(cfg) if g == global_)
