"""Frames → binary-symbol serving pipeline (``svtpu/pipeline.py:30-97,
155-180``).

  pixel path:  uint8 frames (host) → device: → float [0,1] → bilinear
               resize → RBVAE encode (hard Binary-Concrete codes) → codes
  percep path: uint8 frames (host) → host resize to the SD input (1280x704)
               → ``PerceptualEncoder.encode_frames`` (SD latents, the
               attention kernel inside) → percep RBVAE encode → codes

With ``cfg.pallas_trunk`` and ``cfg.pallas_sampler`` set, the RBVAE encode
runs through the hand-written CUDA kernels. Video decode (``run_video``) is
a later slice of the port and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.image import resize_bilinear, resize_u8, to_float01
from svtpu_torch.perceptual.embed import preprocess_size


class VideoSymbolPipeline:
    """Frame batches → ``[N, latent]`` binary codes.

    Args:
      cfg / params: the RBVAE model; ``params`` is its torch state dict
        (reference names, e.g. from ``models.convert.from_jax_params``).
      percep: optional ``PerceptualEncoder``: frames are resized on the
        host to the SD input and SD-encoded first (the percep-RBVAE path).
      temperature / hard / noise / noise_ratio: encode protocol (defaults =
        reference eval: temperature 0.2, hard, noise on).
      seed: noise seed; batch ``i`` draws from ``batch_seed(seed, i)``.
      resize_on: "device" resizes on the card after transfer, as
        ``jax.image.resize`` does (antialiased); "host" resizes the uint8
        frames on the CPU first, as the reference's ``cv2.resize(...,
        INTER_LINEAR)`` does (fewer bytes to move).
      device: CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(self, cfg: RBVAEConfig, params: Mapping[str, torch.Tensor],
                 *, percep=None, temperature: float = 0.2,
                 hard: bool = True, noise: bool = True,
                 noise_ratio: float = 0.1, seed: int = 0,
                 resize_on: str = "device", device=None):
        if resize_on not in ("device", "host"):
            raise ValueError(f"resize_on must be 'device' or 'host': "
                             f"{resize_on!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Seq2SeqBinaryVAE(cfg, device=self.device)
        self.model.load_state_dict(params)
        self.temperature = temperature
        self.hard = hard
        self.noise = noise
        self.noise_ratio = noise_ratio
        self.seed = seed
        self.resize_on = resize_on
        self.percep = percep
        if percep is not None:
            w, h = preprocess_size(percep.cfg.resize_wh)
            self._sd_hw = (h, w)

    def run_video(self, video_path: str,
                  limit: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError(
            "video decode is not ported to svtpu_torch yet; decode frames "
            "and call run_frames")

    def run_frames(self, frames_u8: np.ndarray,
                   batch_index: int = 0) -> np.ndarray:
        """Encode one uint8 ``[N, H, W, C]`` frame batch (any resolution)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
        target = self._sd_hw if self.percep is not None \
            else tuple(self.cfg.input_hw)
        if (self.percep is not None or self.resize_on == "host") \
                and tuple(frames.shape[1:3]) != target:
            frames = resize_u8(frames, target)
        generator = None
        if self.noise:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(batch_seed(self.seed, batch_index))
        with torch.inference_mode():
            if self.percep is not None:
                x = torch.from_numpy(self.percep.encode_frames(
                    frames.numpy())).to(self.device)
            else:
                x = resize_bilinear(to_float01(frames.to(self.device)),
                                    target)
            z = self.model.encode(x[:, None], self.temperature, self.hard,
                                  self.noise_ratio,
                                  deterministic=not self.noise,
                                  generator=generator)
            z = z[:, 0].to(torch.uint8 if self.hard else torch.float32)
        return z.cpu().numpy()

