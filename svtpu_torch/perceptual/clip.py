"""The clip encoder of the perceptual path: V-JEPA 2's video encoder
(``models/vjepa2.py``) over clips of consecutive frames, its features kept
on the card for the percep RBVAE.

A batch of uint8 ``[N, H, W, 3]`` frames goes to the card as it is (from
page-locked memory the copy is the card's DMA and the host does not wait)
and is prepared there, as ``video_processing_vjepa2.py`` prepares a clip:
the shorter side resized to ``cfg.resize_short`` (bilinear, antialiased),
the centre ``crop_size`` square, divided by 255 and normalised by
ImageNet's mean and deviation. The frames are grouped into clips of
``frames_per_clip``; the last clip is padded by repeating its last frame,
as ``evaluation.common.padded_chunks`` pads. On a card the encode is a
CUDA graph a batch shape (``models/encode_graph.py``); the preparation
runs before it, outside the graph.

``encode_frames`` returns the features of every tubelet (``tubelet_size``
frames) of the padded clips, ``[clips * T', h, w, hidden]`` on the card,
one grid a tubelet: the graph's static output, which the next call
overwrites. ``ClipEncoder.clips`` and ``.padded_frames`` count, over the
process, the clips encoded and the frames added to fill a last clip.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from svtpu_torch import resolve_device
from svtpu_torch.config import VJEPA2Config
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.models.vjepa2 import VJEPA2
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.utils.profiling import span


def resized_hw(hw: tuple, short: int) -> tuple[int, int]:
    """The shorter side of ``hw`` at ``short``, the longer one scaled and
    rounded down (720x1280 → 292x519 at 292)."""
    h, w = hw
    if h <= w:
        return short, int(short * w / h)
    return int(short * h / w), short


def norm_constants(cfg: VJEPA2Config, device) -> tuple:
    """The normalisation's mean and deviation, ``[3, 1, 1]`` float32 on
    ``device``."""
    return tuple(torch.tensor(v, device=device)[:, None, None]
                 for v in (cfg.image_mean, cfg.image_std))


def prepare(frames: torch.Tensor, cfg: VJEPA2Config, mean: torch.Tensor,
            std: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` frames → float32 ``[N, 3, crop, crop]``:
    resized, centre-cropped, divided by 255 and normalised by ``mean`` and
    ``std`` (``norm_constants``, on the frames' device)."""
    h, w = resized_hw(tuple(frames.shape[1:3]), cfg.resize_short)
    x = frames.permute(0, 3, 1, 2).float()
    if (h, w) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    c = cfg.crop_size
    top, left = (h - c) // 2, (w - c) // 2
    x = x[:, :, top:top + c, left:left + c]
    return (x / 255.0 - mean) / std


class ClipEncoder(GraphedEncodes):
    """V-JEPA 2's encoder over clips of a frame batch.

    Args:
      params: the encoder's state dict, in the published names.
      cfg: its configuration; ``cfg.compute_dtype`` is the features'.
      device: CUDA unless ``"cpu"`` is asked for. On a card the encode
        runs as a CUDA graph a batch shape (``graph_route``);
        ``drop_graphs()`` frees them.
    """

    clips = 0
    padded_frames = 0

    def __init__(self, params: Mapping[str, torch.Tensor],
                 cfg: VJEPA2Config = VJEPA2Config(), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = VJEPA2(cfg, device=self.device)
        self.model.load_state_dict(params)
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
        """One feature grid a tubelet."""
        return self.cfg.tubelet_size

    def _encode_body(self, inputs, _temperature, _noise_scale, _gen):
        """The device work of one batch of prepared clips: the encoder,
        its features one grid a tubelet."""
        (clips,) = inputs
        t, h, w = self.cfg.grid
        return self.model(clips).reshape(len(clips) * t, h, w, -1)

    def encode_frames(self, frames_u8) -> torch.Tensor:
        """uint8 ``[N, H, W, 3]`` frames (numpy or a tensor, on the host or
        the card) → features ``[ceil(N / frames_per_clip) * T', h, w,
        hidden]`` on the card, tubelet ``j`` of the padded clips holding
        frames ``tubelet_size * j`` onwards."""
        frames = torch.as_tensor(frames_u8)
        n, per = len(frames), self.cfg.frames_per_clip
        clips = -(-n // per)
        with span("svtpu.clip.encode"), torch.inference_mode():
            with span("svtpu.clip.prepare"):
                x = prepare(frames.to(self.device, non_blocking=True),
                            self.cfg, *self._norm)
                if n < clips * per:
                    x = x[torch.arange(clips * per, device=self.device)
                          .clamp_(max=n - 1)]
                x = x.reshape((clips, per) + tuple(x.shape[1:]))
            feats = self.run_encode("clip encode", self.model, (),
                                    self._encode_body, (x,))
        ClipEncoder.clips += clips
        ClipEncoder.padded_frames += clips * per - n
        return feats
