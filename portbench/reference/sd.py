"""The plain reference of Stable Diffusion v1's first stage (the
AutoencoderKL of CompVis ``configs/stable-diffusion/v1-inference.yaml``,
``first_stage_config``): its encoder to the posterior's mode, scaled by
``scale_factor``, as the perceptual path uses it.

Plain PyTorch in float32 with TF32 off, from the published architecture:
``conv_in``; per level ``num_res_blocks`` ResNet blocks (GroupNorm(32,
eps 1e-6) + SiLU + 3x3 conv, twice, a 1x1 shortcut where the width
changes) and, but for the last level, a stride-2 3x3 conv after a (0, 1,
0, 1) pad; the mid block (ResNet block, single-head attention over the
``h * W + w`` tokens with 1x1 projections and scale ``C^-1/2``, ResNet
block); GroupNorm + SiLU + ``conv_out`` to ``2 z`` channels; the 1x1
``quant_conv``; the first ``embed_dim`` channels are the mean. It imports
nothing of the program. ``low=True`` is the control, as in
``reference/rbvae.py``: products from fp8 operands, the rest in bfloat16.

Parameters are a dict in CompVis's state-dict names, float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.rbvae import _dt, _q

ATTN_ROWS = 2048        # query rows a block of the reference's attention


def _levels(sd: dict):
    ch, mult = sd["ch"], sd["ch_mult"]
    return [ch * m for m in mult]


def param_shapes(sd: dict) -> dict:
    """Every parameter of the whole autoencoder (encoder, decoder and
    the quant convs), by state-dict name → shape."""
    out = {}

    def conv(name, cout, cin, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def block(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin, 3)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cout, cin, 1)

    def mid(name, c):
        block(f"{name}.block_1", c, c)
        norm(f"{name}.attn_1.norm", c)
        for p in ("q", "k", "v", "proj_out"):
            conv(f"{name}.attn_1.{p}", c, c, 1)
        block(f"{name}.block_2", c, c)

    widths = _levels(sd)
    z, e = sd["z_channels"], sd["embed_dim"]
    conv("encoder.conv_in", sd["ch"], sd["in_channels"], 3)
    cin = sd["ch"]
    for i, c in enumerate(widths):
        for j in range(sd["num_res_blocks"]):
            block(f"encoder.down.{i}.block.{j}", cin, c)
            cin = c
        if i != len(widths) - 1:
            conv(f"encoder.down.{i}.downsample.conv", c, c, 3)
    mid("encoder.mid", cin)
    norm("encoder.norm_out", cin)
    conv("encoder.conv_out", 2 * z, cin, 3)
    conv("decoder.conv_in", cin, z, 3)
    mid("decoder.mid", cin)
    for i in reversed(range(len(widths))):
        for j in range(sd["num_res_blocks"] + 1):
            block(f"decoder.up.{i}.block.{j}", cin, widths[i])
            cin = widths[i]
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", cin, cin, 3)
    norm("decoder.norm_out", cin)
    conv("decoder.conv_out", sd["out_ch"], cin, 3)
    conv("quant_conv", 2 * e, 2 * z, 1)
    conv("post_quant_conv", z, e, 1)
    return out


def init_weights(sd: dict, seed: int, device) -> dict:
    """Seeded weights on ``device``, drawn by a generator there in one
    call: U(-b, b), b = 1 / sqrt(fan_in), for every conv's weight and
    bias; ones and zeros for the GroupNorms."""
    shapes = param_shapes(sd)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        chunk = flat[at:at + n].view(shape)
        at += n
        if ".norm" in name:
            out[name] = (torch.ones if name.endswith("weight")
                         else torch.zeros)(shape, device=device)
            continue
        w = shapes[name.replace(".bias", ".weight")]
        out[name] = (chunk / math.sqrt(int(np.prod(w[1:])))).contiguous()
    return out


def _conv(w, name, x, low, stride=1, pad=None):
    k = w[f"{name}.weight"]
    p = k.shape[-1] // 2 if pad is None else pad
    return F.conv2d(_q(x, low), _q(k, low), w[f"{name}.bias"].to(_dt(low)),
                    stride, p)


def _norm(w, name, x, low, silu=True):
    """GroupNorm(32, eps 1e-6) (and SiLU) in float32, then the compute
    dtype."""
    h = F.group_norm(x.float(), 32, w[f"{name}.weight"], w[f"{name}.bias"],
                     1e-6)
    return (F.silu(h) if silu else h).to(_dt(low))


def _block(w, name, x, low):
    h = _conv(w, f"{name}.conv1", _norm(w, f"{name}.norm1", x, low), low)
    h = _conv(w, f"{name}.conv2", _norm(w, f"{name}.norm2", h, low), low)
    if f"{name}.nin_shortcut.weight" in w:
        x = _conv(w, f"{name}.nin_shortcut", x, low)
    return x + h


def _attention(w, name, x, low):
    B, C, H, W = x.shape
    h = _norm(w, f"{name}.norm", x, low, silu=False)
    q, k, v = (_conv(w, f"{name}.{p}", h, low).flatten(2).transpose(1, 2)
               for p in ("q", "k", "v"))
    out = torch.empty_like(q)
    kq, vq = _q(k, low), _q(v, low)
    for i in range(0, q.shape[1], ATTN_ROWS):
        s = _q(q[:, i:i + ATTN_ROWS], low) @ kq.transpose(1, 2)
        p = torch.softmax(s.float() / math.sqrt(C), dim=-1).to(q.dtype)
        out[:, i:i + ATTN_ROWS] = _q(p, low) @ vq
    o = out.transpose(1, 2).reshape(B, C, H, W)
    return x + _conv(w, f"{name}.proj_out", o, low)


def resize_host(frames_u8: torch.Tensor, hw) -> torch.Tensor:
    """uint8 frames resized as the perceptual path resizes them on the
    host: bilinear, no antialiasing, rounded to uint8."""
    if tuple(frames_u8.shape[1:3]) == tuple(hw):
        return frames_u8
    x = frames_u8.float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def posterior(w: dict, sd: dict, frames_u8: torch.Tensor,
              low: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 ``[N, H, W, 3]`` at the SD input size → the posterior's mean
    and standard deviation (log-variance clamped to [-30, 20]), unscaled,
    NHWC ``[N, H/8, W/8, embed_dim]`` float32."""
    x = (frames_u8.float() * (2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)
    h = _conv(w, "encoder.conv_in", x.to(_dt(low)), low)
    widths = _levels(sd)
    for i in range(len(widths)):
        for j in range(sd["num_res_blocks"]):
            h = _block(w, f"encoder.down.{i}.block.{j}", h, low)
        if i != len(widths) - 1:
            h = _conv(w, f"encoder.down.{i}.downsample.conv",
                      F.pad(h, (0, 1, 0, 1)), low, stride=2, pad=0)
    h = _block(w, "encoder.mid.block_1", h, low)
    h = _attention(w, "encoder.mid.attn_1", h, low)
    h = _block(w, "encoder.mid.block_2", h, low)
    h = _conv(w, "encoder.conv_out", _norm(w, "encoder.norm_out", h, low),
              low)
    moments = _conv(w, "quant_conv", h, low).float()
    e = sd["embed_dim"]
    mean = moments[:, :e]
    std = torch.exp(0.5 * moments[:, e:2 * e].clamp(-30.0, 20.0))
    return (mean.permute(0, 2, 3, 1).contiguous(),
            std.permute(0, 2, 3, 1).contiguous())


def encode(w: dict, sd: dict, frames_u8: torch.Tensor,
           low: bool = False) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` at the SD input size → the scaled posterior
    mode, NHWC ``[N, H/8, W/8, embed_dim]`` float32."""
    return sd["scale_factor"] * posterior(w, sd, frames_u8, low)[0]
