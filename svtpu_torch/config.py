"""Configurations — the port's own copy of ``svtpu.config``'s
``RBVAEConfig``, ``rbvae_variant`` (``svtpu/config.py:114-254``) and
``PerceptualConfig`` (``:464-479``).

Field names and defaults are the reference's, so one config means the same
model in both packages. ``pallas_trunk`` / ``pallas_sampler`` keep their
names: here they route ``encode`` through the hand-written CUDA kernels
(``ops/conv_trunk_cuda.py``; ``ops/lstm_cuda.py`` after the encoder LSTM,
``ops/binarize_cuda.py`` before it).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RBVAEConfig:
    """One parameterized config covering the four reference variants
    (simple, contrastive, percep, triplet)."""

    variant: str = "contrastive"
    in_channels: int = 3
    out_channels: int = 3
    latent_dim: int = 32
    # Input spatial size (H, W): 256x256 pixels (contrastive/triplet),
    # 64x64 (simple), 88x160 SD latents (percep).
    input_hw: Tuple[int, int] = (256, 256)
    conv_features: Tuple[int, ...] = (64, 64, 64)
    conv_kernel: int = 3
    conv_stride: int = 2
    conv_padding: int = 1
    conv_dropout: float = 0.2
    # ReLU after the LAST encoder conv as well (the simple variant only).
    conv_final_relu: bool = False
    # LSTM depth; hidden size is wired to latent_dim as in every variant.
    lstm_layers: int = 2
    # Identity path around width-preserving LSTM layers.
    lstm_residual: bool = False
    # "pre_rnn" binarizes CNN logits before the LSTMs (simple); "post_rnn"
    # binarizes the encoder-LSTM output (the others).
    binarize: str = "post_rnn"
    bc_eps: float = 1e-8
    # Whether the noise_ratio multiplier exists (contrastive/percep).
    has_noise_ratio: bool = True
    decoder_sigmoid: bool = True
    # Compute dtype for conv/matmul; parameters are always float32.
    compute_dtype: str = "float32"
    # Accepted for config compatibility; the port has no training slice yet.
    remat: bool = False
    # Inference ``encode`` through the hand-written sampler kernels (fused
    # with the encoder LSTM where the variant binarizes after it).
    pallas_sampler: bool = False
    # Inference ``encode`` through the hand-written conv0+conv1 kernel
    # (contrastive/triplet 256x256 pixel geometry only).
    pallas_trunk: bool = False
    # Accepted and ignored: the Hopper kernel picks its own tiles.
    pallas_trunk_block: int = 1
    # Not ported yet: the model raises NotImplementedError when set.
    int8_trunk: bool = False
    conv0_s2d: bool = False
    deconv_d2s: bool = False

    @property
    def encoded_hw(self) -> Tuple[int, int]:
        h, w = self.input_hw
        for _ in self.conv_features:
            h = (h + 2 * self.conv_padding - self.conv_kernel) // self.conv_stride + 1
            w = (w + 2 * self.conv_padding - self.conv_kernel) // self.conv_stride + 1
        return (h, w)

    @property
    def encoded_dim(self) -> int:
        h, w = self.encoded_hw
        return self.conv_features[-1] * h * w

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def rbvae_variant(name: str, latent_dim: int = 32, *,
                  compute_dtype: str = "float32", **overrides) -> RBVAEConfig:
    """Factory for the four reference variants by name (and the sweep
    aliases ``contrastive_z``/``contrastive_p``/``percep_p``)."""
    name = {"contrastive_z": "contrastive",
            "contrastive_p": "contrastive",
            "percep_p": "percep"}.get(name, name)
    base = dict(latent_dim=latent_dim, compute_dtype=compute_dtype)
    if name == "simple":
        cfg = dict(
            variant="simple", input_hw=(64, 64), conv_features=(64, 128, 256),
            conv_kernel=4, conv_dropout=0.0, conv_final_relu=True,
            lstm_layers=1, binarize="pre_rnn", bc_eps=1e-10,
            has_noise_ratio=False)
    elif name == "contrastive":
        cfg = dict(variant="contrastive")
    elif name == "triplet":
        cfg = dict(variant="triplet", has_noise_ratio=False)
    elif name == "percep":
        cfg = dict(
            variant="percep", in_channels=4, out_channels=4,
            input_hw=(88, 160), conv_features=(256, 256, 256), lstm_layers=4)
    else:
        raise ValueError(f"unknown RBVAE variant: {name!r}")
    cfg.update(base)
    cfg.update(overrides)
    return RBVAEConfig(**cfg)


@dataclasses.dataclass(frozen=True)
class PerceptualConfig:
    """SD AutoencoderKL first-stage config (v1-inference.yaml:46-67)."""

    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215
    # Preprocessing: resize target before %32 snap
    # (``get_percep_embeddings.py:59-66``) — 1280x720 → 1280x704.
    resize_wh: Tuple[int, int] = (1280, 720)
    compute_dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)
