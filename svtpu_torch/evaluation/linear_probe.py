"""Linear-regression probe from RBVAE hidden states to pixels
(``svtpu/evaluation/linear_probe.py``): fit a linear map from the encoder's
``h_seq`` to flattened pixels; report R², MSE, MAE and explained variance;
save an example reconstruction. The fit needs sklearn, the example image
matplotlib; both are imported where they are used.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from svtpu_torch.evaluation.common import RBVAEBundle, padded_chunks


@torch.no_grad()
def hidden_states(bundle: RBVAEBundle, frames: np.ndarray,
                  temperature: float = 0.2, chunk: int = 64) -> np.ndarray:
    """Encoder ``h_seq`` per frame (T=1 sequences, noise off) →
    ``[N, latent]``.

    Runs the plain encoder half (conv stack, then the encoder LSTM), as
    ``svtpu`` reads ``h_seq`` from its plain forward pass: the fused
    LSTM + sampler kernel does not return ``h``, and neither package has a
    kernel route for this probe.
    """
    model = bundle.model
    parts = []
    for _, part, n in padded_chunks(np.asarray(frames), chunk):
        x = bundle.load_frames(part)[:, None]
        _, h, _ = model._encode_to_latent(x, temperature, False, 0.0, None,
                                          None)
        parts.append(h[:n, 0].float().cpu().numpy())
    return np.concatenate(parts)


def evaluate_linear_probe(bundle: RBVAEBundle, frames: np.ndarray,
                          targets01: Optional[np.ndarray] = None,
                          example_path: Optional[str | Path] = None) -> Dict:
    from sklearn.linear_model import LinearRegression
    from sklearn.metrics import (explained_variance_score,
                                 mean_absolute_error, mean_squared_error,
                                 r2_score)

    if targets01 is None:
        targets01 = frames
    if targets01.dtype == np.uint8:
        targets01 = targets01.astype(np.float32) / 255.0
    H = hidden_states(bundle, frames)
    Y = targets01.reshape(len(targets01), -1)
    reg = LinearRegression().fit(H, Y)
    pred = reg.predict(H)
    metrics = {
        "r2": float(r2_score(Y, pred)),
        "mse": float(mean_squared_error(Y, pred)),
        "mae": float(mean_absolute_error(Y, pred)),
        "explained_variance": float(explained_variance_score(Y, pred)),
    }
    if example_path is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        shape = targets01.shape[1:]
        axes[0].imshow(np.clip(targets01[0], 0, 1))
        axes[0].set_title("target")
        axes[1].imshow(np.clip(pred[0].reshape(shape), 0, 1))
        axes[1].set_title("linear reconstruction")
        for a in axes:
            a.axis("off")
        fig.tight_layout()
        fig.savefig(example_path, dpi=120)
        plt.close(fig)
    return metrics
