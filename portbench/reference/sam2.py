"""The plain reference of SAM 2.1's image encoder (Hiera-L with its FPN
neck; ``facebook/sam2.1-hiera-large``, "SAM 2: Segment Anything in Images
and Videos"), as the image path uses it: the preprocessing, the Hiera
backbone and the FPN's 64x64 level, and the percep RBVAE's encode of the
features (``reference/rbvae.py``).

Plain PyTorch in float32 with TF32 off, from the published equations
(``sam2/modeling/backbones/hieradet.py``; transformers'
``modeling_sam2.py``):

  * preprocessing (``image_processing_sam2_fast.py``): each frame resized
    to ``image_size`` square, the aspect ratio not kept (bilinear,
    antialiased, as torchvision resizes a uint8 image: the result rounded
    to whole grey levels), divided by 255, normalised by ImageNet's mean
    and deviation;
  * the patch embed: ``Conv2d(3, C, 7, stride 4, padding 3)``, channels
    last, plus ``pos_embed`` bicubic-interpolated to the grid and
    ``pos_embed_window`` tiled over it;
  * multi-scale blocks: ``xn = LN1 x``; the residual ``x``, or where the
    width changes ``maxpool2x2(proj(xn))`` (the pool at the query-pool
    stages); ``xn`` partitioned into windows (zero-padded to a multiple
    of the window; no partition for a global block); ``qkv = Linear(xn)``
    as ``(3, heads, head_dim)``; at a stage's first block q max-pooled 2x2
    inside each window; softmax attention scaled by ``head_dim^-0.5``;
    ``proj``; the windows joined (with the pooled window) and the padding
    dropped; ``x = res + o``, ``x += proj_out(GELU(proj_in(LN2 x)))``,
    GELU by erf, LayerNorm eps 1e-6;
  * the neck's top-down path down to stage 3: ``conv1x1(stage 3) +
    nearest_up2(conv1x1(stage 4))``, ``fpn_hidden_states[-1]``.

Departures: attention is computed in blocks of ``ATTN_ROWS`` queries, and
frames one at a time, so that the global blocks (4,096 tokens) and the
first stage (65,536 tokens) fit at 32 frames; the 256² and 128² FPN levels
(the mask decoder's) are not computed. It imports nothing of the program.
``low=True`` is the control, as in ``reference/rbvae.py``: every product
(the embed, the linears, the neck, q kᵀ and p v) from fp8 e4m3 operands,
the rest in bfloat16.

Parameters are a dict in the published state-dict names, float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.rbvae import _dt, _q

ATTN_ROWS = 1024        # query rows a block of the reference's attention


def blocks(cfg: dict) -> list:
    """Each block's ``(dim_in, dim_out, heads, window, pooled)``: the
    previous stage's width and window at a stage's first block, window 0
    at the global blocks, queries pooled at the first block of stages 2 to
    ``num_query_pool_stages + 1``."""
    out = []
    dims, heads = cfg["embed_dim_per_stage"], cfg["num_attention_heads_per_stage"]
    wins = cfg["window_size_per_stage"]
    for st, n in enumerate(cfg["blocks_per_stage"]):
        for j in range(n):
            first = st > 0 and j == 0
            prev = st - 1 if first else st
            window = 0 if len(out) in cfg["global_attention_blocks"] \
                else wins[prev]
            out.append((dims[prev], dims[st], heads[st], window,
                        first and st <= cfg["num_query_pool_stages"]))
    return out


def param_shapes(cfg: dict) -> dict:
    """Every parameter of the vision encoder, by state-dict name → shape."""
    C0 = cfg["embed_dim_per_stage"][0]
    k = cfg["patch_kernel_size"]
    w0 = cfg["window_size_per_stage"][0]
    out = {"backbone.pos_embed": (1, C0, *cfg[
               "window_positional_embedding_background_size"]),
           "backbone.pos_embed_window": (1, C0, w0, w0),
           "backbone.patch_embed.projection.weight": (C0, cfg["num_channels"],
                                                      k, k),
           "backbone.patch_embed.projection.bias": (C0,)}
    for i, (din, dout, _, _, _) in enumerate(blocks(cfg)):
        pre = f"backbone.blocks.{i}"
        M = int(dout * cfg["mlp_ratio"])
        lin = [("attn.qkv", 3 * dout, din), ("attn.proj", dout, dout),
               ("mlp.proj_in", M, dout), ("mlp.proj_out", dout, M)]
        if din != dout:
            lin.append(("proj", dout, din))
        for name, o, n in lin:
            out[f"{pre}.{name}.weight"] = (o, n)
            out[f"{pre}.{name}.bias"] = (o,)
        for norm, d in (("layer_norm1", din), ("layer_norm2", dout)):
            out[f"{pre}.{norm}.weight"] = (d,)
            out[f"{pre}.{norm}.bias"] = (d,)
    for j, c in enumerate(cfg["backbone_channel_list"]):
        out[f"neck.convs.{j}.weight"] = (cfg["fpn_hidden_size"], c, 1, 1)
        out[f"neck.convs.{j}.bias"] = (cfg["fpn_hidden_size"],)
    return out


def init_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights on ``device`` at transformers' init, drawn by a
    generator there in one call: every product's weight from N(0, 0.02),
    biases zero, LayerNorm ones and zeros; the two position embeddings,
    which that init zeroes, from N(0, 0.02) too, so that the position path
    is exercised and checked."""
    shapes = param_shapes(cfg)
    drawn = [k for k, s in shapes.items()
             if (k.endswith(".weight") and len(s) > 1) or "pos_embed" in k]
    sizes = [int(np.prod(shapes[k])) for k in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(sum(sizes), device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    out, at = {}, 0
    for name, n in zip(drawn, sizes):
        out[name] = flat[at:at + n].view(shapes[name]).clone()
        at += n
    for name, shape in shapes.items():
        if name not in out:
            ones = "layer_norm" in name and name.endswith(".weight")
            out[name] = (torch.ones if ones else torch.zeros)(
                shape, device=device)
    return out


def preprocess(cfg: dict, frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` → float32 ``[N, 3, S, S]``."""
    s = cfg["image_size"]
    x = frames_u8.float().permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != (s, s):
        x = F.interpolate(x, size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True)
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    mean = torch.tensor(cfg["image_mean"], device=x.device)[:, None, None]
    std = torch.tensor(cfg["image_std"], device=x.device)[:, None, None]
    return (x / 255.0 - mean) / std


def _linear(w, name, x, low):
    return _q(x, low) @ _q(w[f"{name}.weight"], low).T \
        + w[f"{name}.bias"].to(_dt(low))


def _ln(w, name, x, low, eps):
    return F.layer_norm(x.float(), x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], eps).to(_dt(low))


def _maxpool(x):
    """2x2 max pool of ``[B, H, W, C]`` (floor, as ``max_pool2d``)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def window_partition(x, ws):
    """``[B, H, W, C]`` → ``[B * windows, ws, ws, C]``, zero-padded to a
    multiple of ``ws``; and the padded ``(H, W)``."""
    B, H, W, C = x.shape
    ph, pw = -H % ws, -W % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _attend(q, k, v, low):
    """``softmax(q kᵀ / sqrt(D)) v`` of ``[n, heads, N, D]`` operands, in
    blocks of ``ATTN_ROWS`` queries."""
    D = q.shape[-1]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    kq, vq = _q(k, low), _q(v, low)
    for i in range(0, q.shape[2], ATTN_ROWS):
        s = _q(q[:, :, i:i + ATTN_ROWS], low) @ kq.transpose(-1, -2)
        p = torch.softmax(s.float() / math.sqrt(D), dim=-1).to(v.dtype)
        out[:, :, i:i + ATTN_ROWS] = _q(p, low) @ vq
    return out


def _block(w, pre, cfg, spec, x, low):
    din, dout, heads, window, pooled = spec
    eps = cfg["layer_norm_eps"]
    xn = _ln(w, f"{pre}.layer_norm1", x, low, eps)
    res = x
    if din != dout:
        res = _linear(w, f"{pre}.proj", xn, low)
        if pooled:
            res = _maxpool(res)
    H, W = x.shape[1:3]
    xw, pad_hw = window_partition(xn, window) if window else (xn, (H, W))
    n, h, ww = xw.shape[:3]
    qkv = _linear(w, f"{pre}.attn.qkv", xw, low).reshape(
        n, h * ww, 3, heads, -1)
    q, k, v = qkv.unbind(2)
    if pooled:
        q = _maxpool(q.reshape(n, h, ww, -1))
        h, ww = q.shape[1:3]
        q = q.reshape(n, h * ww, heads, -1)
    o = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), low)
    o = _linear(w, f"{pre}.attn.proj",
                o.transpose(1, 2).reshape(n, h, ww, -1), low)
    if window:
        wq = window // 2 if pooled else window
        Hr, Wr = res.shape[1:3]
        o = window_unpartition(o, wq, (Hr + -Hr % wq, Wr + -Wr % wq),
                               (Hr, Wr))
    x = res + o
    hid = _linear(w, f"{pre}.mlp.proj_in",
                  _ln(w, f"{pre}.layer_norm2", x, low, eps), low)
    return x + _linear(w, f"{pre}.mlp.proj_out", F.gelu(hid), low)


def _conv1x1(w, name, x, low):
    k = w[f"{name}.weight"]
    return _q(x, low) @ _q(k.flatten(1), low).T + w[f"{name}.bias"].to(_dt(low))


def encoder(w: dict, cfg: dict, images: torch.Tensor, low: bool = False
            ) -> torch.Tensor:
    """Preprocessed images ``[B, 3, S, S]`` → the FPN's 64x64 level ``[B,
    64, 64, fpn_hidden_size]``, float32."""
    dt = _dt(low)
    k = w["backbone.patch_embed.projection.weight"]
    x = F.conv2d(_q(images.to(dt), low), _q(k, low),
                 w["backbone.patch_embed.projection.bias"].to(dt),
                 stride=cfg["patch_stride"], padding=cfg["patch_padding"])
    x = x.permute(0, 2, 3, 1)
    pe = F.interpolate(w["backbone.pos_embed"], size=tuple(x.shape[1:3]),
                       mode="bicubic")
    win = w["backbone.pos_embed_window"]
    pe = pe + win.tile(1, 1, pe.shape[2] // win.shape[2],
                       pe.shape[3] // win.shape[3])
    x = x + pe.permute(0, 2, 3, 1).to(dt)
    ends = np.cumsum(cfg["blocks_per_stage"]) - 1
    stages = []
    for i, spec in enumerate(blocks(cfg)):
        x = _block(w, f"backbone.blocks.{i}", cfg, spec, x, low)
        if i in ends:
            stages.append(x)
    top = _conv1x1(w, "neck.convs.0", stages[3], low)
    lat = _conv1x1(w, "neck.convs.1", stages[2], low)
    if 2 in cfg["fpn_top_down_levels"]:
        up = F.interpolate(top.permute(0, 3, 1, 2).float(), scale_factor=2.0,
                           mode="nearest").to(lat.dtype)
        lat = lat + up.permute(0, 2, 3, 1)
    return lat.float()


def features(w: dict, cfg: dict, frames_u8: torch.Tensor,
             low: bool = False) -> torch.Tensor:
    """uint8 frames → features ``[N, 64, 64, fpn_hidden_size]``, one frame
    at a time."""
    x = preprocess(cfg, frames_u8)
    return torch.cat([encoder(w, cfg, x[b:b + 1], low)
                      for b in range(len(x))])
