"""The image encoder of the perceptual path: SAM 2.1's Hiera-L image
encoder (``models/sam2.py``) over each frame, its features kept on the
card for the percep RBVAE.

A batch of uint8 ``[N, H, W, 3]`` frames goes to the card as it is (from
page-locked memory the copy is the card's DMA and the host does not wait)
and is prepared there as ``image_processing_sam2_fast.py`` prepares an
image: resized to ``image_size`` square (bilinear, antialiased, the aspect
ratio not kept; torchvision's resize of a uint8 image, which rounds the
result back to whole grey levels), divided by 255 and normalised by
ImageNet's mean and deviation. On a card the encode is a CUDA graph a
batch shape (``models/encode_graph.py``); the preparation runs before it,
outside the graph.

``encode_frames`` returns the FPN's 64x64 level of every frame, ``[N, 64,
64, 256]`` on the card: the graph's static output, which the next call
overwrites. ``Sam2Encoder.frames`` counts, over the process, the frames
encoded.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from svtpu_torch import resolve_device
from svtpu_torch.config import Sam2HieraConfig
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.models.sam2 import Sam2ImageEncoder
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.perceptual.clip import norm_constants
from svtpu_torch.utils.profiling import span


def prepare(frames: torch.Tensor, cfg: Sam2HieraConfig, mean: torch.Tensor,
            std: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` frames → float32 ``[N, 3, S, S]``: resized to
    ``S = image_size`` and rounded to whole grey levels, divided by 255 and
    normalised by ``mean`` and ``std`` (``norm_constants``, on the frames'
    device)."""
    s = cfg.image_size
    x = frames.permute(0, 3, 1, 2).float()
    if tuple(x.shape[2:]) != (s, s):
        x = F.interpolate(x, size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True)
        x = x.round_().clamp_(0.0, 255.0)
    return (x / 255.0 - mean) / std


class Sam2Encoder(GraphedEncodes):
    """SAM 2.1's image encoder over the frames of a batch.

    Args:
      params: the vision encoder's state dict, in the published names.
      cfg: its configuration; ``cfg.compute_dtype`` is the features'.
      device: CUDA unless ``"cpu"`` is asked for. On a card the encode
        runs as a CUDA graph a batch shape (``graph_route``);
        ``drop_graphs()`` frees them.
    """

    frames = 0

    def __init__(self, params: Mapping[str, torch.Tensor],
                 cfg: Sam2HieraConfig = Sam2HieraConfig(), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Sam2ImageEncoder(cfg, params=params, device=self.device)
        # Made once: a tensor built from host numbers in a request would
        # wait for the card.
        self._norm = norm_constants(cfg, self.device)
        self._graphed = graph_route(self.device) == "graph"

    @property
    def input_hw(self) -> None:
        """None: ``encode_frames`` takes frames of any size and resizes
        them itself, on the card."""
        return None

    @property
    def frames_per_code(self) -> int:
        """One feature grid a frame."""
        return 1

    def _encode_body(self, inputs, _temperature, _noise_scale, _gen):
        (images,) = inputs
        return self.model(images)

    def encode_frames(self, frames_u8) -> torch.Tensor:
        """uint8 ``[N, H, W, 3]`` frames (numpy or a tensor, on the host or
        the card) → features ``[N, 64, 64, 256]`` on the card."""
        frames = torch.as_tensor(frames_u8)
        with span("svtpu.sam2.encode"), torch.inference_mode():
            with span("svtpu.sam2.prepare"):
                x = prepare(frames.to(self.device, non_blocking=True),
                            self.cfg, *self._norm)
            feats = self.run_encode("sam2 encode", self.model, (),
                                    self._encode_body, (x,))
        Sam2Encoder.frames += len(frames)
        return feats
