"""AutoencoderKL — the Stable-Diffusion perceptual autoencoder; the port of
``svtpu/models/autoencoder_kl.py``.

Only the live path of the CompVis first stage is rebuilt: Encoder, Decoder,
DiagonalGaussian and the quant convs. The modules carry the CompVis
state-dict names (``encoder.down.{i}.block.{b}.norm1``,
``encoder.down.{i}.downsample.conv``, ``encoder.mid.attn_1.{norm,q,k,v,
proj_out}``, ``decoder.up.{i}.upsample.conv``, ...), so a
``first_stage_model.*`` state dict loads with ``load_state_dict`` once its
prefix is stripped (``perceptual/convert.py::load_sd_first_stage``).

Public layout is the JAX package's: ``encode`` takes ``[B, H, W, 3]`` in
[-1, 1] and returns moments ``[B, H/8, W/8, 2·embed]``, ``decode`` maps
``[B, h, w, embed]`` back to ``[B, H, W, 3]``; inside, the convs run NCHW
in channels-last memory (the encoder's input is a permuted NHWC tensor, and
the norms keep that layout). Rounding is ``svtpu``'s: GroupNorm(32, eps
1e-6) and SiLU in f32, then a cast to the compute dtype; convs in the
compute dtype with f32 parameters; residual adds in the compute dtype.
The mid-block attention runs through the hand-written kernel
(``ops/attention.py``) unless ``use_kernel=False``, as ``svtpu``'s
``AttnBlock(use_pallas=False)`` runs the XLA version.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from svtpu_torch import resolve_device
from svtpu_torch.config import PerceptualConfig
from svtpu_torch.ops.attention import attention
from svtpu_torch.ops import draws
from svtpu_torch.ops.group_norm import group_norm_silu
from svtpu_torch.ops.conv import Conv2dTorch


class GroupNormSiLU(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) and optional SiLU in f32, then the compute
    dtype (``autoencoder_kl.py:40-53``): ``ops/group_norm.py``, whose
    kernel on the card writes channels-last, so the convs after it take
    channels-last inputs."""

    def __init__(self, channels: int, silu: bool = True):
        super().__init__(32, channels, eps=1e-6)
        self.silu = silu

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.eps,
                               self.silu, dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(cin)
        self.conv1 = Conv2dTorch(cin, cout, 3, 1, 1)
        self.norm2 = GroupNormSiLU(cout)
        self.conv2 = Conv2dTorch(cout, cout, 3, 1, 1)
        if cin != cout:
            self.nin_shortcut = Conv2dTorch(cin, cout, 1, 1, 0)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        h = self.conv1(self.norm1(x, dtype), dtype)
        h = self.conv2(self.norm2(h, dtype), dtype)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x, dtype)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the spatial tokens, 1x1-conv projections.
    Tokens are ordered ``h·W + w``, as ``svtpu``'s NHWC reshape orders
    them."""

    def __init__(self, channels: int, use_kernel: bool = True):
        super().__init__()
        self.norm = GroupNormSiLU(channels, silu=False)
        self.q = Conv2dTorch(channels, channels, 1, 1, 0)
        self.k = Conv2dTorch(channels, channels, 1, 1, 0)
        self.v = Conv2dTorch(channels, channels, 1, 1, 0)
        self.proj_out = Conv2dTorch(channels, channels, 1, 1, 0)
        self.use_kernel = use_kernel

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x, dtype)
        q, k, v = (m(h, dtype).flatten(2).transpose(1, 2).contiguous()
                   for m in (self.q, self.k, self.v))
        o = attention(q, k, v, use_kernel=self.use_kernel)
        o = o.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(o, dtype)


class Downsample(nn.Module):
    """Asymmetric (0,1,0,1) pad + stride-2 conv (model.py:60-79)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2dTorch(channels, channels, 3, 2, 0)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)), dtype)


class Upsample(nn.Module):
    """Nearest 2x + conv3x3 (model.py:42-57)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2dTorch(channels, channels, 3, 1, 1)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x, dtype)


class _Level(nn.Module):
    """One resolution level: ``block`` (ResnetBlocks) and an optional
    ``downsample`` / ``upsample``, under the CompVis names."""

    def __init__(self, blocks: list[ResnetBlock]):
        super().__init__()
        self.block = nn.ModuleList(blocks)


class _Mid(nn.Module):
    def __init__(self, channels: int, use_kernel: bool):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels, use_kernel)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = self.block_1(x, dtype)
        x = self.attn_1(x, dtype)
        return self.block_2(x, dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: PerceptualConfig, use_kernel: bool = True):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv2dTorch(cfg.in_channels, cfg.ch, 3, 1, 1)
        self.down = nn.ModuleList()
        cin = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(cin, cfg.ch * mult))
                cin = cfg.ch * mult
            level = _Level(blocks)
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(cin)
            self.down.append(level)
        self.mid = _Mid(cin, use_kernel)
        self.norm_out = GroupNormSiLU(cin)
        self.conv_out = Conv2dTorch(cin, 2 * cfg.z_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image → NCHW moments, in the compute dtype."""
        dt = self.cfg.torch_dtype
        h = self.conv_in(x, dt)
        for level in self.down:
            for block in level.block:
                h = block(h, dt)
            if hasattr(level, "downsample"):
                h = level.downsample(h, dt)
        h = self.mid(h, dt)
        return self.conv_out(self.norm_out(h, dt), dt)


class Decoder(nn.Module):
    def __init__(self, cfg: PerceptualConfig, use_kernel: bool = True):
        super().__init__()
        self.cfg = cfg
        cin = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2dTorch(cfg.z_channels, cin, 3, 1, 1)
        self.mid = _Mid(cin, use_kernel)
        levels: list[Optional[_Level]] = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            cout = cfg.ch * cfg.ch_mult[i]
            blocks = []
            # num_res_blocks + 1 blocks per level (model.py:511).
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, cout))
                cin = cout
            levels[i] = _Level(blocks)
            if i != 0:
                levels[i].upsample = Upsample(cin)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNormSiLU(cin)
        self.conv_out = Conv2dTorch(cin, cfg.out_ch, 3, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents → NCHW image, in the compute dtype."""
        dt = self.cfg.torch_dtype
        h = self.mid(self.conv_in(z, dt), dt)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, dt)
            if hasattr(level, "upsample"):
                h = level.upsample(h, dt)
        return self.conv_out(self.norm_out(h, dt), dt)


class DiagonalGaussian(NamedTuple):
    """Moments of the encoder posterior
    (``ldm/modules/distributions/distributions.py:24-62``), NHWC."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments.float(), 2, dim=-1)
        return cls(mean, torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: draws.Source) -> torch.Tensor:
        """``mean + std * noise``; ``generator`` may be a
        ``draws.ShardedGenerator`` (one rank's rows of a global batch)."""
        noise = draws.randn(self.mean.shape, generator, self.mean.dtype,
                            self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(self.mean ** 2 + var - 1.0 - self.logvar,
                               dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean) ** 2 / var, dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """Encoder + quant convs + Decoder (``ldm/models/autoencoder.py:285-333``).

    ``encode`` returns posterior moments (apply ``DiagonalGaussian``);
    ``decode`` maps latents back to pixels. The 0.18215 ``scale_factor``
    lives in ``perceptual/embed.py``, as in ``svtpu``.

    ``device``: where the parameters live; CUDA unless ``"cpu"`` is asked
    for (raises when there is no card). ``generator``: a CPU
    ``torch.Generator`` for the initial weights (U(±1/sqrt(fan_in)) for the
    convs, ones and zeros for the norms); seed 0 when omitted.
    ``use_kernel``: the mid-block attention through the hand-written kernel
    (True) or its plain version.
    """

    def __init__(self, cfg: PerceptualConfig = PerceptualConfig(), *,
                 device=None, generator: Optional[torch.Generator] = None,
                 use_kernel: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, use_kernel)
        self.decoder = Decoder(cfg, use_kernel)
        self.quant_conv = Conv2dTorch(2 * cfg.z_channels, 2 * cfg.embed_dim,
                                      1, 1, 0)
        self.post_quant_conv = Conv2dTorch(cfg.embed_dim, cfg.z_channels,
                                           1, 1, 0)
        self._init_weights(generator or torch.Generator().manual_seed(0))
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv2dTorch):
                bound = 1 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound)
                            - bound)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` in [-1, 1] → moments ``[B, H/8, W/8, 2·embed]``
        in the compute dtype."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        return self.quant_conv(h, self.cfg.torch_dtype).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, h, w, embed]`` latents → ``[B, 8h, 8w, 3]`` in the compute
        dtype."""
        h = self.post_quant_conv(z.permute(0, 3, 1, 2), self.cfg.torch_dtype)
        return self.decoder(h).permute(0, 2, 3, 1)
