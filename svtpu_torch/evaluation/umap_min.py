"""Minimal dependency-free UMAP (numpy, scipy and sklearn's kNN only); the
port's own copy of ``svtpu/evaluation/umap_min.py``, line for line, so that
both packages give the same layout for the same codes and seed.

The reference's geometry eval projects codes with the ``umap-learn``
package (n_neighbors 24, min_dist 0.25), which may be absent. This module
implements the UMAP algorithm itself (McInnes, Healy & Melville 2018,
arXiv:1802.03426) from the paper's definitions — fuzzy simplicial set
construction with smooth-kNN calibration, spectral initialization, and the
negative-sampling SGD layout — sized for the eval workload (hundreds to a
few thousand code vectors).

Differences vs umap-learn (deliberate): no NN-descent (exact kNN via
sklearn — fine at eval sizes), no low-memory/sparse paths, and the
per-epoch edge schedule is vectorized numpy rather than numba. Results are
qualitatively equivalent, not bit-identical.
"""
from __future__ import annotations

import numpy as np

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def _knn(x: np.ndarray, n_neighbors: int):
    from sklearn.neighbors import NearestNeighbors

    nn = NearestNeighbors(n_neighbors=n_neighbors).fit(x)
    dists, idx = nn.kneighbors(x)
    return idx, dists.astype(np.float64)


def smooth_knn_dist(dists: np.ndarray, k: float, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest nonzero distance; sigma solves
    sum_j exp(-max(0, d_ij - rho)/sigma) = log2(k)  (paper Algorithm 3)."""
    target = np.log2(k)
    rho = np.zeros(dists.shape[0])
    sigma = np.zeros(dists.shape[0])
    for i in range(dists.shape[0]):
        nonzero = dists[i][dists[i] > 0.0]
        rho[i] = nonzero[0] if len(nonzero) else 0.0
        lo, hi, mid = 0.0, np.inf, 1.0
        d = np.maximum(dists[i] - rho[i], 0.0)
        for _ in range(n_iter):
            psum = np.exp(-d / mid).sum()
            if abs(psum - target) < SMOOTH_K_TOLERANCE:
                break
            if psum > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        sigma[i] = mid
        mean_d = dists[i].mean()
        if rho[i] > 0.0:
            sigma[i] = max(sigma[i], MIN_K_DIST_SCALE * mean_d)
        else:
            sigma[i] = max(sigma[i], MIN_K_DIST_SCALE * dists.mean())
    return rho, sigma


def fuzzy_simplicial_set(x: np.ndarray, n_neighbors: int):
    """Symmetrized fuzzy graph as COO arrays (rows, cols, weights)."""
    n = x.shape[0]
    idx, dists = _knn(x, n_neighbors)
    rho, sigma = smooth_knn_dist(dists, float(n_neighbors))
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), n_neighbors)
    cols = idx.ravel()
    vals = w.ravel()
    # Drop self-edges, build dense-free symmetric union W + Wt - W∘Wt.
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    m = {}
    for r, c, v in zip(rows, cols, vals):
        m[(int(r), int(c))] = float(v)
    sym = {}
    for (r, c), v in m.items():
        vt = m.get((c, r), 0.0)
        sym[(r, c)] = v + vt - v * vt
        sym[(c, r)] = sym[(r, c)]
    out = np.array([(r, c, v) for (r, c), v in sym.items() if r < c])
    return (out[:, 0].astype(np.int64), out[:, 1].astype(np.int64),
            out[:, 2])


def find_ab_params(min_dist: float, spread: float = 1.0):
    """Least-squares fit of 1/(1 + a d^{2b}) to the target membership curve
    (exp(-(d - min_dist)/spread) beyond min_dist, 1 inside)."""
    from scipy.optimize import curve_fit

    def curve(d, a, b):
        return 1.0 / (1.0 + a * d ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=10_000)
    return float(a), float(b)


def spectral_init(n: int, rows, cols, vals, dim: int = 2,
                  seed: int = 0) -> np.ndarray:
    """Symmetric-normalized-Laplacian eigenvectors (dense eigh — fine at
    eval sizes); random fallback on numerical failure."""
    rng = np.random.default_rng(seed)
    try:
        W = np.zeros((n, n))
        W[rows, cols] = vals
        W[cols, rows] = vals
        deg = W.sum(1)
        deg[deg == 0] = 1.0
        dinv = 1.0 / np.sqrt(deg)
        L = np.eye(n) - dinv[:, None] * W * dinv[None, :]
        evals, evecs = np.linalg.eigh(L)
        emb = evecs[:, 1:dim + 1]
        scale = 10.0 / (np.abs(emb).max() + 1e-12)
        return emb * scale + rng.normal(0, 1e-4, (n, dim))
    except np.linalg.LinAlgError:
        return rng.uniform(-10, 10, (n, dim))


def optimize_layout(emb: np.ndarray, rows, cols, vals, a: float, b: float,
                    n_epochs: int = 300, initial_alpha: float = 1.0,
                    negative_sample_rate: int = 5, seed: int = 0,
                    move_other: bool = True) -> np.ndarray:
    """Negative-sampling SGD over the fuzzy graph (paper Algorithm 5),
    vectorized per epoch: each edge fires on its weight-proportional
    schedule; gradients are clipped to ±4 and scatter-added."""
    rng = np.random.default_rng(seed)
    n = emb.shape[0]
    emb = emb.astype(np.float64).copy()
    epochs_per_sample = vals.max() / np.maximum(vals, 1e-12)
    next_fire = epochs_per_sample.copy()

    for epoch in range(1, n_epochs + 1):
        alpha = initial_alpha * (1.0 - epoch / n_epochs)
        live = next_fire <= epoch
        if not live.any():
            continue
        next_fire[live] += epochs_per_sample[live]
        r, c = rows[live], cols[live]
        grad_acc = np.zeros_like(emb)

        # Attractive along edges.
        d = emb[r] - emb[c]
        dist2 = (d * d).sum(1)
        coef = (-2.0 * a * b * dist2 ** (b - 1.0)
                / (a * dist2 ** b + 1.0))[:, None]
        g = np.clip(coef * d, -4.0, 4.0)
        np.add.at(grad_acc, r, g)
        if move_other:
            np.add.at(grad_acc, c, -g)

        # Repulsive vs negative samples.
        for _ in range(negative_sample_rate):
            neg = rng.integers(0, n, r.shape[0])
            dn = emb[r] - emb[neg]
            dist2n = (dn * dn).sum(1) + 1e-3
            coefn = (2.0 * b / (dist2n * (a * dist2n ** b + 1.0)))[:, None]
            gn = np.clip(coefn * dn, -4.0, 4.0)
            gn[neg == r] = 0.0
            np.add.at(grad_acc, r, gn)
        emb += alpha * grad_acc
    return emb


def umap_embed(x: np.ndarray, n_neighbors: int = 24,
               min_dist: float = 0.25, n_epochs: int = 300,
               seed: int = 0) -> np.ndarray:
    """→ [N, 2] UMAP embedding (reference hyperparameters by default)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    k = int(min(n_neighbors, max(2, n - 1)))
    rows, cols, vals = fuzzy_simplicial_set(x, k)
    a, b = find_ab_params(min_dist)
    emb = spectral_init(n, rows, cols, vals, seed=seed)
    return optimize_layout(emb, rows, cols, vals, a, b,
                           n_epochs=n_epochs, seed=seed)
