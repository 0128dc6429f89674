"""Inter-state Hamming distance between modal binary codes
(``svtpu/evaluation/hamming.py``): the encode protocol at temperature 0.2,
hard, noise ratio 0.3, the CSV and the chart."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from svtpu_torch.evaluation.common import RBVAEBundle, labels_of


def modal_codes(codes: np.ndarray, labels: np.ndarray,
                num_states: int) -> np.ndarray:
    """Most-common binary code per state → ``[num_states, latent]``."""
    out = np.zeros((num_states, codes.shape[1]), np.uint8)
    bits = codes > 0.5
    for s in range(num_states):
        vecs = bits[labels == s]
        if len(vecs) == 0:
            continue
        uniq, cnt = np.unique(vecs, axis=0, return_counts=True)
        out[s] = uniq[np.argmax(cnt)]
    return out


def adjacent_hamming(modal: np.ndarray) -> np.ndarray:
    """Hamming distance between each adjacent state pair → ``[S-1]``."""
    return np.sum(modal[:-1] != modal[1:], axis=1)


def evaluate_hamming(bundle: RBVAEBundle, frames: np.ndarray,
                     frame_indices: Sequence[int], flags: Sequence[int],
                     temperature: float = 0.2, noise_ratio: float = 0.3,
                     seed: int = 0, labels=None) -> Dict:
    """Encode → modal code per state → adjacent Hamming distances.

    ``labels``: optional explicit per-frame state labels (one global state
    axis across videos); when given, ``flags``/``frame_indices`` are
    ignored for labeling."""
    labels, num_states = labels_of(frame_indices, flags, labels)
    codes = bundle.encode(frames, temperature=temperature, hard=True,
                          noise=True, noise_ratio=noise_ratio, seed=seed)
    modal = modal_codes(codes, labels, num_states)
    ham = adjacent_hamming(modal)
    return {"modal_codes": modal, "hamming": ham,
            "mean_hamming": float(ham.mean()) if len(ham) else 0.0}


def write_csv(results: Dict[str, Dict], path: str | Path):
    lines = ["model,state_pair,hamming_distance"]
    for name, r in results.items():
        for i, h in enumerate(r["hamming"]):
            lines.append(f"{name},{i}-{i + 1},{int(h)}")
    Path(path).write_text("\n".join(lines) + "\n")


def plot_results(results: Dict[str, Dict], path: str | Path):
    """Bar chart of each model's adjacent-pair distances (needs
    matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    width = 0.8 / max(len(results), 1)
    for mi, (name, r) in enumerate(sorted(results.items())):
        ham = r["hamming"]
        x = np.arange(len(ham))
        ax.bar(x + mi * width, ham, width, label=name)
    ax.set_xlabel("adjacent state pair")
    ax.set_ylabel("Hamming distance")
    ax.set_title("Inter-state Hamming distance of modal codes")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
