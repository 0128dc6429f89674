"""Embedding-geometry projections: UMAP / t-SNE / PCA scatter plots
(``svtpu/evaluation/projections.py``).

2-D projections of *soft* codes (hard=False) coloured by state label, with
the reference's hyperparameters (UMAP n_neighbors 24 / min_dist 0.25, t-SNE
perplexity 30, PCA 2 components). UMAP uses umap-learn when installed, else
the port's minimal implementation (``umap_min.py``). PCA, t-SNE and the
kNN of ``umap_min`` need sklearn, the charts matplotlib; both are imported
where they are used.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from svtpu_torch.evaluation.common import RBVAEBundle, labels_of


def soft_codes(bundle: RBVAEBundle, frames: np.ndarray,
               temperature: float = 0.2, noise_ratio: float = 0.1,
               seed: int = 0) -> np.ndarray:
    return bundle.encode(frames, temperature=temperature, hard=False,
                         noise=True, noise_ratio=noise_ratio, seed=seed)


def project(codes: np.ndarray, method: str = "pca",
            seed: int = 0) -> Optional[np.ndarray]:
    """→ ``[N, 2]``."""
    if method == "pca":
        from sklearn.decomposition import PCA
        return PCA(n_components=2, random_state=seed).fit_transform(codes)
    if method == "tsne":
        from sklearn.manifold import TSNE
        perp = min(30.0, max(2.0, len(codes) / 4))
        return TSNE(n_components=2, perplexity=perp,
                    random_state=seed).fit_transform(codes)
    if method == "umap":
        try:
            import umap
        except ImportError:
            from svtpu_torch.evaluation.umap_min import umap_embed
            return umap_embed(codes, n_neighbors=24, min_dist=0.25,
                              seed=seed)
        return umap.UMAP(n_neighbors=24, min_dist=0.25,
                         random_state=seed).fit_transform(codes)
    raise ValueError(method)


def plot_projection(xy: np.ndarray, labels: np.ndarray, path: str | Path,
                    title: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=labels, cmap="tab10", s=12)
    ax.set_title(title)
    fig.colorbar(sc, ax=ax, label="state")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def evaluate_projections(bundle: RBVAEBundle, frames: np.ndarray,
                         frame_indices: Sequence[int], flags: Sequence[int],
                         out_dir: str | Path,
                         methods: Sequence[str] = ("pca", "tsne", "umap"),
                         seed: int = 0) -> Dict[str, str]:
    """One chart a method, ``<out_dir>/<bundle name>_<method>.png``; returns
    the paths by method."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    labels, _ = labels_of(frame_indices, flags)
    codes = soft_codes(bundle, frames, seed=seed)
    written = {}
    for m in methods:
        xy = project(codes, m, seed)
        p = out_dir / f"{bundle.name}_{m}.png"
        plot_projection(xy, labels, p, f"{bundle.name} — {m.upper()}")
        written[m] = str(p)
    return written
