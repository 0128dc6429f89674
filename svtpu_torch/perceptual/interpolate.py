"""Latent-space interpolation demo on the perceptual autoencoder; the port of
``svtpu/perceptual/interpolate.py``.

Encode two frames (image paths, decoded by ``load_frame_pm1``, or uint8
arrays), interpolate in SD latent space, decode every step (in the
encoder's batches). The decode runs the decoder's mid-block attention, so
it reaches the attention kernel too.
"""
from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np

from svtpu_torch.parallel import distributed
from svtpu_torch.perceptual.embed import PerceptualEncoder, load_frame_pm1


def lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    return (1.0 - t) * a + t * b


def slerp(a: np.ndarray, b: np.ndarray, t: float,
          eps: float = 1e-8) -> np.ndarray:
    """Spherical interpolation on flattened latents; falls back to lerp for
    nearly-parallel vectors (the reference's threshold behavior)."""
    af, bf = a.reshape(-1), b.reshape(-1)
    na, nb = np.linalg.norm(af), np.linalg.norm(bf)
    dot = float(np.dot(af, bf) / max(na * nb, eps))
    dot = np.clip(dot, -1.0, 1.0)
    if abs(dot) > 0.9995:
        return lerp(a, b, t)
    theta = np.arccos(dot)
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b


def interpolate_images(encoder: PerceptualEncoder,
                       image_a: str | Path | np.ndarray,
                       image_b: str | Path | np.ndarray, steps: int = 8,
                       mode: Literal["lerp", "slerp"] = "slerp",
                       out_path: str | Path | None = None) -> np.ndarray:
    """Two frames (image paths, or uint8 ``[H, W, 3]`` arrays) →
    ``[steps, H, W, 3]`` decoded pixels in [0, 1]; with ``out_path``, also a
    strip of the steps as an image (needs matplotlib), written by rank 0
    alone under a process group while the other ranks wait."""
    def load(x):
        if isinstance(x, (str, Path)):
            return load_frame_pm1(str(x), encoder.cfg.resize_wh)
        return np.asarray(x)

    za, zb = encoder.encode_frames(np.stack([load(image_a), load(image_b)]))
    interp = slerp if mode == "slerp" else lerp
    ts = np.linspace(0.0, 1.0, steps)
    zs = np.stack([interp(za, zb, float(t)) for t in ts])
    decoded = encoder.decode_latents(zs)
    if out_path is not None:
        distributed.main_then_barrier(_save_strip, decoded, ts, out_path)
    return decoded


def _save_strip(decoded: np.ndarray, ts: np.ndarray,
                out_path: str | Path) -> None:
    """The decoded steps side by side, each titled with its t."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(ts), figsize=(2 * len(ts), 2.4))
    for ax, img, t in zip(np.atleast_1d(axes), decoded, ts):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(f"t={t:.2f}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
