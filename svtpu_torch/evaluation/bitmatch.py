"""Symbol bit-match fidelity against reference checkpoints
(``svtpu/evaluation/bitmatch.py``).

In deterministic mode (no Binary-Concrete noise) the hard codes of a
reference checkpoint must match the reference model's exactly; stochastic
mode matches only in distribution, so fidelity is measured with noise off.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from svtpu_torch.config import RBVAEConfig
from svtpu_torch.evaluation.common import RBVAEBundle


def bit_match(codes_a: np.ndarray, codes_b: np.ndarray) -> Dict[str, float]:
    """Compare two ``[N, L]`` hard code arrays: per-bit match % and exact
    whole-code match %."""
    a = np.asarray(codes_a) > 0.5
    b = np.asarray(codes_b) > 0.5
    if a.shape != b.shape:
        raise ValueError(f"code shapes differ: {a.shape} vs {b.shape}")
    per_bit = float(np.mean(a == b))
    exact = float(np.mean(np.all(a == b, axis=-1)))
    return {"bit_match_pct": 100.0 * per_bit,
            "exact_code_match_pct": 100.0 * exact,
            "n_frames": int(a.shape[0]), "latent_dim": int(a.shape[1])}


def codes_from_torch_checkpoint(state_dict, cfg: RBVAEConfig,
                                frames: np.ndarray,
                                temperature: float = 0.2,
                                device=None) -> np.ndarray:
    """Encode ``frames`` deterministically with a reference torch state
    dict, which the port's model loads as it is (no converter)."""
    bundle = RBVAEBundle(cfg, state_dict, name="ported", device=device)
    return bundle.encode(frames, temperature=temperature, hard=True,
                         noise=False)
