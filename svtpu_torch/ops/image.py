"""Device-side image preprocessing and perturbations
(``svtpu/ops/image.py:15-57``).

Layout is NHWC (``[..., H, W, C]``) at every public function, as in the
JAX package. The perturbations draw from an explicit ``torch.Generator`` on
the tensor's device, in place of a JAX key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_float01(x_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] → float [0,1] (torchvision ``ToTensor`` scaling)."""
    return x_u8.to(dtype) * (1.0 / 255.0)


def to_pm1(x01: torch.Tensor) -> torch.Tensor:
    """[0,1] → [-1,1] (SD encoder input convention)."""
    return 2.0 * x01 - 1.0


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


def add_gaussian_noise(x01: torch.Tensor, generator: torch.Generator,
                       std: float = 0.1, mean: float = 0.0) -> torch.Tensor:
    """Gaussian pixel noise, clipped to [0,1]."""
    noise = torch.randn(x01.shape, generator=generator, dtype=x01.dtype,
                        device=x01.device) * std + mean
    return torch.clamp(x01 + noise, 0.0, 1.0)


def occlude(x: torch.Tensor, top, left, side_h: int, side_w: int,
            value: float) -> torch.Tensor:
    """``x`` (``[..., H, W, C]``) with the ``side_h`` x ``side_w`` square at
    corner ``(top, left)`` set to ``value``, the same square in every
    leading index. The corner may be an int or a one-element tensor on
    ``x``'s device; it is never read on the host."""
    H, W = x.shape[-3], x.shape[-2]
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    mask = ((rows >= top) & (rows < top + side_h)
            & (cols >= left) & (cols < left + side_w))
    return torch.where(mask[..., None], torch.full((), value, dtype=x.dtype,
                                                   device=x.device), x)


def random_corner(generator: torch.Generator, H: int, W: int, side_h: int,
                  side_w: int):
    """A square's corner, uniform over ``[0, H - side_h]`` x
    ``[0, W - side_w]``, as one-element tensors on the generator's
    device."""
    dev = generator.device
    top = torch.randint(0, H - side_h + 1, (1,), generator=generator,
                        device=dev)
    left = torch.randint(0, W - side_w + 1, (1,), generator=generator,
                         device=dev)
    return top, left


def add_occlusion(x01: torch.Tensor, generator: torch.Generator,
                  coverage: float = 0.2, value: float = 0.5) -> torch.Tensor:
    """Grey-square occlusion covering ``coverage`` of the image, at a
    random position per call, shared across the leading dims of ``[..., H,
    W, C]`` (one square per call, as the reference draws it)."""
    H, W = x01.shape[-3], x01.shape[-2]
    side = int((coverage * H * W) ** 0.5)
    top, left = random_corner(generator, H, W, side, side)
    return occlude(x01, top, left, side, side, value)
