"""SAM 2.1's image encoder (Hiera-L with its FPN neck; "SAM 2: Segment
Anything in Images and Videos", ``facebookresearch/sam2``), the encoder of
the image path (``perceptual/sam2.py``).

The modules carry the published state-dict names of transformers'
``Sam2VisionModel`` (``backbone.patch_embed.projection.*``,
``backbone.pos_embed``, ``backbone.pos_embed_window``,
``backbone.blocks.{i}.{layer_norm1,attn.{qkv,proj},proj,layer_norm2,
mlp.{proj_in,proj_out}}.*``, ``neck.convs.{j}.*``), so a checkpoint's
vision encoder loads with ``load_state_dict``. ``neck.convs.2`` and ``.3``
(the 256² and 128² laterals, which only the mask decoder reads) are held
for that and not run.

Equations (``modeling_sam2.py``): the patch embed (``Conv2d``, kernel 7,
stride 4, padding 3) gives a channels-last ``[B, 256, 256, 144]`` grid, to
which the windowed position embedding is added: ``pos_embed`` (7x7)
bicubic-interpolated to the grid plus ``pos_embed_window`` (8x8) tiled
over it, a table built once for a set of weights (``pos_table``). Block
``i`` (``Sam2HieraConfig.blocks``): ``xn = LN1(x)``; the residual is ``x``,
or where the width changes ``maxpool2x2(proj(xn))``; ``qkv = Linear(xn)``
splits into q, k and v of ``heads`` heads of 72; at the first block of
stages 2-4 q is max-pooled 2x2 (inside its window, the windows being
even); attention inside the block's windows (global at blocks 23, 33, 43),
scaled by ``72^-0.5``; ``x = res + proj(o)``, then ``x += proj_out(GELU(
proj_in(LN2 x)))`` (GELU by erf, LayerNorm eps 1e-6). The output is the
FPN's 64x64 level: ``conv1x1(stage 3) + nearest_up2(conv1x1(stage 4))``,
``Sam2VisionModel(...).fpn_hidden_states[-1]``, the image embedding SAM 2's
mask decoder reads, channels last ``[B, 64, 64, 256]``.

Rounding (as ``models/vjepa2.py``): products in the compute dtype with
float32 parameters, LayerNorm statistics in float32, the residual stream
in float32, the features cast once to the compute dtype. A linear's bias
is added in its product's epilogue (``F.linear``), not by a pass of its
own over the output. Attention runs
through ``ops/attention.window_attention``: on the card the D = 72 kernels
(``csrc/window_attention.cu``), which read q, k and v in place in the qkv
product's grid and write the output grid (no window partition copies);
its plain version on the CPU. Window sides must tile the grids (true at the
published 1024x1024): a grid that needs padding raises.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from svtpu_torch import resolve_device
from svtpu_torch.config import Sam2HieraConfig
from svtpu_torch.models.vjepa2 import LayerNorm
from svtpu_torch.ops.attention import window_attention


def pos_table(pos_embed: torch.Tensor, pos_embed_window: torch.Tensor,
              grid: int) -> torch.Tensor:
    """The windowed position embedding of a ``grid`` x ``grid`` token grid,
    float32 ``[grid, grid, C]``: ``pos_embed [1, C, h, w]`` bicubic to the
    grid plus ``pos_embed_window [1, C, s, s]`` tiled over it. Counts its
    builds in ``pos_table.builds``."""
    pe = F.interpolate(pos_embed.float(), size=(grid, grid), mode="bicubic")
    win = pos_embed_window.float()
    pe = pe + win.tile(1, 1, grid // win.shape[2], grid // win.shape[3])
    pos_table.builds += 1
    return pe[0].permute(1, 2, 0).contiguous()


pos_table.builds = 0


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of a channels-last ``[B, H, W, C]`` grid."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype) -> torch.Tensor:
    """``x @ w.T + b`` in ``dtype``, the bias in the product's
    epilogue."""
    return F.linear(x.to(dtype), w.to(dtype), b.to(dtype))


class Dense(nn.Linear):
    """``nn.Linear`` whose forward runs in a given compute dtype."""

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return linear(x, self.weight, self.bias, dtype)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: Sam2HieraConfig):
        super().__init__()
        self.projection = nn.Conv2d(
            cfg.num_channels, cfg.embed_dim_per_stage[0],
            cfg.patch_kernel_size, cfg.patch_stride, cfg.patch_padding)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``[B, 3, S, S]`` → channels-last ``[B, S / 4, S / 4, C]``."""
        p = self.projection
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, p.weight.to(dtype), p.bias.to(dtype), p.stride,
                     p.padding)
        return y.permute(0, 2, 3, 1)


class _Attention(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.qkv = Dense(dim_in, 3 * dim_out)
        self.proj = Dense(dim_out, dim_out)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj_in = Dense(dim, hidden)
        self.proj_out = Dense(hidden, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x, dtype=dtype)),
                             dtype=dtype)


class Block(nn.Module):
    """One multi-scale block; ``window`` (0: global) and ``pooled`` are
    plain attributes, read at every call."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, window: int,
                 pooled: bool, cfg: Sam2HieraConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.dim_out, self.heads = dim_out, heads
        self.window, self.pooled = window, pooled
        self.layer_norm1 = LayerNorm(dim_in, eps=eps)
        self.attn = _Attention(dim_in, dim_out)
        self.layer_norm2 = LayerNorm(dim_out, eps=eps)
        self.mlp = _FeedForward(dim_out, int(dim_out * cfg.mlp_ratio))
        if dim_in != dim_out:
            self.proj = Dense(dim_in, dim_out)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        xn = self.layer_norm1(x, dtype)
        res = x
        if hasattr(self, "proj"):
            res = self.proj(xn, dtype=dtype)
            if self.pooled:
                res = pool2(res)
        C = self.dim_out
        qkv = self.attn.qkv(xn, dtype=dtype)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        if self.pooled:
            q = pool2(q)
        o = window_attention(q, k, v, self.heads, self.window)
        x = res.float() + self.attn.proj(o, dtype=dtype)
        return x + self.mlp(self.layer_norm2(x, dtype), dtype)


class _Backbone(nn.Module):
    def __init__(self, cfg: Sam2HieraConfig):
        super().__init__()
        C = cfg.embed_dim_per_stage[0]
        w = cfg.window_size_per_stage[0]
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, C, *cfg.window_positional_embedding_background_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, C, w, w))
        self.blocks = nn.ModuleList(
            Block(din, dout, heads, window, pooled, cfg)
            for _, din, dout, heads, window, pooled in cfg.blocks)


class _Neck(nn.Module):
    def __init__(self, cfg: Sam2HieraConfig):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(c, cfg.fpn_hidden_size, 1)
                                   for c in cfg.backbone_channel_list)


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    return linear(x, conv.weight.flatten(1), conv.bias, dtype)


class Sam2ImageEncoder(nn.Module):
    """The encoder: ``forward`` maps normalised images ``[B, 3, S, S]``
    (``S = image_size``) to the FPN's 64x64 level, ``[B, 64, 64,
    fpn_hidden_size]`` in the compute dtype.

    ``params``: a state dict in the published names, loaded before the
    position table is built; without it the weights are drawn by
    ``generator`` (a ``torch.Generator`` on the device; seed 0 when
    omitted) at transformers' init (every product's weight N(0, 0.02),
    biases zero, LayerNorm ones and zeros) with the position embeddings
    drawn N(0, 0.02) too (that init zeroes them). ``device``: where the
    parameters and the table live; CUDA unless ``"cpu"`` is asked for. A
    later ``load_state_dict`` rebuilds the table in place.
    """

    def __init__(self, cfg: Sam2HieraConfig = Sam2HieraConfig(), *,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.backbone_channel_list != tuple(reversed(
                cfg.embed_dim_per_stage)) or len(cfg.blocks_per_stage) != 4:
            raise ValueError("the neck reads the four stages' outputs")
        dev = resolve_device(device)
        self.cfg = cfg
        self.stage_ends = [sum(cfg.blocks_per_stage[:s + 1]) - 1
                           for s in range(4)]
        with torch.device(dev):
            self.backbone = _Backbone(cfg)
            self.neck = _Neck(cfg)
        if params is not None:
            self.load_state_dict(params)
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            self._init_weights(generator)
        bb = self.backbone
        self.register_buffer("pos_table", pos_table(
            bb.pos_embed, bb.pos_embed_window, cfg.grid), persistent=False)
        self.register_load_state_dict_post_hook(_rebuild_table)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.normal_(m.weight, std=0.02, generator=gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for p in (self.backbone.pos_embed, self.backbone.pos_embed_window):
            nn.init.normal_(p, std=0.02, generator=gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.torch_dtype
        bb = self.backbone
        x = bb.patch_embed(images, dt).float() + self.pos_table
        stages = []
        for i, block in enumerate(bb.blocks):
            x = block(x, dt)
            if i in self.stage_ends:
                stages.append(x)
        convs = self.neck.convs
        top = _conv1x1(convs[0], stages[3], dt)
        lat = _conv1x1(convs[1], stages[2], dt).float()
        if 2 in self.cfg.fpn_top_down_levels:
            B, h, w, C = top.shape
            lat = lat.view(B, h, 2, w, 2, C) + top[:, :, None, :, None, :]
        B, H, W = stages[2].shape[:3]
        return lat.reshape(B, H, W, -1).to(dt)


@torch.no_grad()
def _rebuild_table(model: Sam2ImageEncoder, _incompatible) -> None:
    bb = model.backbone
    model.pos_table.copy_(pos_table(bb.pos_embed, bb.pos_embed_window,
                                    model.cfg.grid))
