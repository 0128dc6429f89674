"""Batched perceptual-embedding encoder on one card; the port of
``svtpu/perceptual/embed.py:34-116``.

Only the AutoencoderKL runs (no UNet or CLIP); uint8 frames travel to the
card and are normalised there; the posterior is sampled
(``posterior.sample()``, the reference's ``ddpm.py:542-549``) or taken at
its mode. Latents come back as NHWC ``[N, H/8, W/8, 4]`` float32 numpy
arrays, scaled by ``scale_factor``.

Decoding frames from image files (``load_frame_pm1``) and the directory
precompute (``precompute_embeddings``) need a JPEG decoder and wait for the
video-decode slice of the port.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import PerceptualConfig
from svtpu_torch.models.autoencoder_kl import AutoencoderKL, DiagonalGaussian


def preprocess_size(resize_wh: Tuple[int, int]) -> Tuple[int, int]:
    """(W, H) after the %32 snap (``get_percep_embeddings.py:59-66``):
    1280x720 → 1280x704."""
    w, h = resize_wh
    return (w - w % 32, h - h % 32)


class PerceptualEncoder:
    """AutoencoderKL encode and decode in batches of ``batch_size``.

    Args:
      params: the AutoencoderKL's CompVis-named state dict (from
        ``perceptual.convert``).
      stochastic: sample the posterior (True) or take its mode.
      seed: posterior noise; the batch starting at frame ``i`` draws from
        ``batch_seed(seed, i)``, in place of ``fold_in(key(seed), i)``.
      device: CUDA unless ``"cpu"`` is asked for.
      use_kernel: the mid-block attention through the hand-written kernel.
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 cfg: PerceptualConfig = PerceptualConfig(),
                 batch_size: int = 8, stochastic: bool = True, seed: int = 0,
                 device=None, use_kernel: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = AutoencoderKL(cfg, device=self.device,
                                   use_kernel=use_kernel)
        self.model.load_state_dict(params)
        self.batch_size = batch_size
        self.stochastic = stochastic
        self.seed = seed

    def _encode(self, frames_u8: torch.Tensor, offset: int) -> torch.Tensor:
        x = frames_u8.to(self.device).float() * (2.0 / 255.0) - 1.0
        post = DiagonalGaussian.from_moments(self.model.encode(x))
        if self.stochastic:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(batch_seed(self.seed, offset))
            z = post.sample(gen)
        else:
            z = post.mode()
        return self.cfg.scale_factor * z

    def encode_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """``[N, H, W, 3]`` uint8 → ``[N, H/8, W/8, 4]`` float32 latents."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
        out = []
        with torch.inference_mode():
            for i in range(0, len(frames), self.batch_size):
                out.append(self._encode(frames[i:i + self.batch_size], i)
                           .cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def decode_latents(self, z_nhwc: np.ndarray) -> np.ndarray:
        """Scaled latents → [0, 1] pixels ``[N, H, W, 3]`` float32."""
        z = torch.from_numpy(np.ascontiguousarray(z_nhwc, np.float32))
        out = []
        with torch.inference_mode():
            for i in range(0, len(z), self.batch_size):
                zb = z[i:i + self.batch_size].to(self.device) \
                    / self.cfg.scale_factor
                x = self.model.decode(zb).float()
                out.append(torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
                           .cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)
