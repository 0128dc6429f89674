"""Several videos on one global state axis: the port's counterpart of
``svtpu/data/multi.py``.

Each video's state segments are concatenated into one global state axis,
so the contrastive "adjacent state" structure works across video
boundaries and one model learns symbols for all of them. Video ``k``'s
local frame ``i`` has the global id ``k * OFFSET + i``, which keeps every
consumer (pair tables, gathers, label maps) pure index arithmetic.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from svtpu_torch.config import VideoMeta
from svtpu_torch.data.segments import (SplitIndices, assign_label,
                                       split_segments)

# One video's frame ids live in [k*OFFSET, (k+1)*OFFSET), far above any
# real frame count.
OFFSET = 10_000_000


class MultiStore:
    """Routes gathers over global frame ids to the per-video stores."""

    def __init__(self, stores: Sequence):
        if not stores:
            raise ValueError("need at least one store")
        shapes = {tuple(s.item_shape) for s in stores}
        if len(shapes) != 1:
            raise ValueError(f"stores disagree on item_shape: {shapes}")
        self.stores = list(stores)
        self._array = None

    @property
    def item_shape(self):
        return self.stores[0].item_shape

    # The staging interface (``Trainer`` puts ``array`` on the device once
    # and gathers ``rows`` there): one concatenated bank and the global id
    # → bank row map.

    @property
    def array(self) -> np.ndarray:
        """The sub-stores' arrays concatenated (built on first use);
        ``AttributeError`` where a sub-store has no ``array``/``rows``."""
        if not all(hasattr(s, "array") and hasattr(s, "rows")
                   for s in self.stores):
            raise AttributeError("sub-stores lack array/rows")
        if self._array is None:
            self._array = np.concatenate(
                [np.asarray(s.array) for s in self.stores])
        return self._array

    def rows(self, frame_indices) -> np.ndarray:
        idx = np.asarray(frame_indices)
        video = idx // OFFSET
        local = idx % OFFSET
        base, acc = [], 0
        for s in self.stores:
            base.append(acc)
            acc += len(s.array)
        out = np.empty(idx.shape, np.int64)
        for k, s in enumerate(self.stores):
            sel = video == k
            if sel.any():
                out[sel] = base[k] + s.rows(local[sel])
        return out

    def gather(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        flat = idx.reshape(-1)
        video = flat // OFFSET
        local = flat % OFFSET
        out = None
        for k, store in enumerate(self.stores):
            sel = np.nonzero(video == k)[0]
            if not len(sel):
                continue
            part = np.asarray(store.gather(local[sel]))
            if out is None:
                out = np.empty((len(flat),) + part.shape[1:], part.dtype)
            out[sel] = part
        if out is None:
            raise ValueError("empty index array")
        return out.reshape(idx.shape + out.shape[1:])


def combine_videos(specs: Sequence[Tuple[object, VideoMeta]],
                   test_pct: float = 0.1, val_pct: float = 0.1,
                   ) -> Tuple[MultiStore, SplitIndices, Dict[int, int]]:
    """``[(store, VideoMeta), ...]`` → ``(store, splits, labels)``: a
    routing :class:`MultiStore`; each video's states split as
    ``split_segments`` splits them, their frame ids made global and the
    states concatenated across videos; and a global frame id → global state
    id map over every frame of every video (grey-out margins included, as
    ``assign_label`` labels a single video)."""
    train: List[Tuple[int, ...]] = []
    test: List[Tuple[int, ...]] = []
    val: List[Tuple[int, ...]] = []
    labels: Dict[int, int] = {}
    state_base = 0
    for k, (store, meta) in enumerate(specs):
        frame_base = k * OFFSET
        sp = split_segments(meta.state_segments(), test_pct, val_pct)
        for part, acc in ((sp.train, train), (sp.test, test), (sp.val, val)):
            acc.extend(tuple(frame_base + i for i in state)
                       for state in part)
        for i in range(meta.last_frame + 1):
            labels[frame_base + i] = state_base + assign_label(i, meta.flags)
        state_base += meta.num_states
    stores = MultiStore([s for s, _ in specs])
    return stores, SplitIndices(tuple(train), tuple(test), tuple(val)), labels
