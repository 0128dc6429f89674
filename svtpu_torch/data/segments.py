"""State-segment arithmetic: labels and train/test/val splits; the port's
copy of ``svtpu/data/segments.py:16-64``.

Deterministic, pure-numpy reimplementation of the index logic inside the
reference's ``ShuffledStatePairDataset``
(``contrastive_RBVAE_train.py:170-327``): per state, a contiguous *middle*
chunk becomes test+val and the front+back remainder is train.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def assign_label(frame_index: int, flags: Sequence[int]) -> int:
    """Frame index → state id via transition flags
    (``contrastive_RBVAE_train.py:330-341``)."""
    label = 0
    for f in flags:
        if frame_index >= f:
            label += 1
        else:
            break
    return label


@dataclasses.dataclass(frozen=True)
class SplitIndices:
    """Per-state frame-index lists for each split."""

    train: Tuple[Tuple[int, ...], ...]
    test: Tuple[Tuple[int, ...], ...]
    val: Tuple[Tuple[int, ...], ...]

    def of(self, mode: str) -> Tuple[Tuple[int, ...], ...]:
        return getattr(self, mode)

    def flat(self, mode: str) -> List[int]:
        return [i for state in self.of(mode) for i in state]


def split_segments(state_segments: Sequence[Tuple[int, int]],
                   test_pct: float = 0.1,
                   val_pct: float = 0.1) -> SplitIndices:
    """Middle-chunk split, identical arithmetic to the reference
    (``contrastive_RBVAE_train.py:207-237``)."""
    train, test, val = [], [], []
    for (start, end) in state_segments:
        full = list(range(start, end))
        n = len(full)
        tv_count = int(n * (test_pct + val_pct))
        margin = (n - tv_count) // 2
        tv = full[margin:margin + tv_count]
        tr = full[:margin] + full[margin + tv_count:]
        if tv_count > 0:
            test_count = int(round(test_pct / (test_pct + val_pct) * tv_count))
            te, va = tv[:test_count], tv[test_count:]
        else:
            te, va = [], []
        train.append(tuple(tr))
        test.append(tuple(te))
        val.append(tuple(va))
    return SplitIndices(tuple(train), tuple(test), tuple(val))
