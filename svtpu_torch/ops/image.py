"""Device-side image preprocessing (``svtpu/ops/image.py:15-29``).

Layout is NHWC (``[..., H, W, C]``) at every public function, as in the
JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_float01(x_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] → float [0,1] (torchvision ``ToTensor`` scaling)."""
    return x_u8.to(dtype) * (1.0 / 255.0)


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int],
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize over the two spatial dims of ``[..., H, W, C]``.

    ``antialias=True`` matches ``jax.image.resize(..., "bilinear")``, which
    antialiases when it downsamples (a triangle kernel widened by the
    scale); without it a 432x768 → 256x256 resize is off by up to 0.6 on
    [0, 1] pixels. ``antialias=False`` is ``cv2.resize(...,
    INTER_LINEAR)``'s interpolation, which the reference's host-side resize
    uses.
    """
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    if (H, W) == tuple(hw):
        return x
    nchw = x.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(lead + (hw[0], hw[1], C))


def resize_u8(frames: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """uint8 ``[N, H, W, C]`` frames resized as the reference's host-side
    ``cv2.resize(..., INTER_LINEAR)`` does (no antialiasing; within one
    grey level of cv2's fixed-point rounding), back to uint8."""
    return resize_bilinear(frames.float(), hw, antialias=False) \
        .round().clamp(0, 255).to(torch.uint8)
