"""Inter-state Hamming distance between modal binary codes
(``svtpu/evaluation/hamming.py:17-33``)."""
from __future__ import annotations

import numpy as np


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
