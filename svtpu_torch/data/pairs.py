"""Deterministic pair construction for shuffled state-pair training; the
port's copy of ``svtpu/data/pairs.py:20-86`` (identical arrays for the same
seeds).

Reimplements the semantics of the reference's pair builder
(``contrastive_RBVAE_train.py:244-294``) — pad every state's index list to
the max state length by resampling, shuffle, form disjoint pairs — but with
seeded ``numpy.random.Generator`` instead of Python's module-level ``random``
(which the reference never seeds; SURVEY.md §7 notes epoch-level pair sets
therefore cannot match the reference bit-for-bit, only distributionally).

The output is a dense ``[num_pairs, num_states, 2]`` int32 array: pure index
arithmetic, trivially testable, and directly gatherable on device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def build_pairs(indices_per_state: Sequence[Sequence[int]],
                seed: int) -> np.ndarray:
    """Build one epoch's pair table.

    Args:
      indices_per_state: per-state frame-index lists (one split of
        ``SplitIndices``).
      seed: epoch seed; same seed → same pairs.

    Returns:
      ``[num_pairs, num_states, 2]`` int32 frame indices; item ``i`` of the
      dataset is row ``i`` (the i-th pair from EVERY state), matching the
      reference ``__getitem__`` layout (``contrastive_RBVAE_train.py:299-319``,
      modulo its per-state wraparound which dense padding makes unnecessary).
    """
    rng = np.random.default_rng(seed)
    states = [list(s) for s in indices_per_state]
    if any(len(s) == 0 for s in states):
        raise ValueError("every state needs at least one frame index")
    max_frames = max(len(s) for s in states)

    per_state_pairs = []
    for idx in states:
        if len(idx) < max_frames:
            pad = rng.choice(np.asarray(idx), size=max_frames - len(idx),
                             replace=True)
            padded = np.concatenate([np.asarray(idx), pad])
        else:
            padded = np.asarray(idx)
        rng.shuffle(padded)
        n_pairs = len(padded) // 2
        pairs = padded[:2 * n_pairs].reshape(n_pairs, 2)
        if len(padded) % 2 == 1:
            leftover = padded[-1]
            others = [x for x in idx if x != leftover]
            mate = rng.choice(np.asarray(others)) if others else leftover
            pairs = np.concatenate([pairs, [[leftover, mate]]], axis=0)
        per_state_pairs.append(pairs)

    max_pairs = max(len(p) for p in per_state_pairs)
    out = np.zeros((max_pairs, len(states), 2), np.int32)
    for s, pairs in enumerate(per_state_pairs):
        reps = -(-max_pairs // len(pairs))
        tiled = np.tile(pairs, (reps, 1))[:max_pairs]
        out[:, s, :] = tiled
    return out


def epoch_batches(pair_table: np.ndarray, batch_size: int, seed: int,
                  shuffle: bool = True,
                  drop_remainder: bool = False) -> np.ndarray:
    """Shuffle the pair table and pad it to whole batches.

    Returns ``[num_batches, batch, num_states, 2]``. Padding resamples
    existing rows so every batch keeps a static shape for jit.
    """
    rng = np.random.default_rng(seed)
    n = len(pair_table)
    order = rng.permutation(n) if shuffle else np.arange(n)
    if drop_remainder:
        n_keep = (n // batch_size) * batch_size
        order = order[:n_keep]
    else:
        pad = (-n) % batch_size
        if pad:
            order = np.concatenate([order, rng.choice(n, pad)])
    return pair_table[order].reshape(-1, batch_size, *pair_table.shape[1:])
