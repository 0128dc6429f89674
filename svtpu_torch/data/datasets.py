"""In-memory frame / embedding stores and the pair-batch pipeline
(``svtpu/data/datasets.py:36-226``).

Frames are decoded once into a contiguous uint8 NHWC array at the target
resolution; every epoch then only gathers rows. Batches keep static shapes
``[B, 2, S, H, W, C]``; uint8 travels to the device and is normalised
there. Same seeds, same arrays as the JAX package.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from svtpu_torch.data.pairs import build_pairs, epoch_batches
from svtpu_torch.data.segments import split_segments


def _decode_frame(path: str, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    # torchvision T.Resize((H, W)) uses bilinear; match it.
    img = img.resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


class FrameStore:
    """All frames of one video, decoded to ``[N, H, W, 3]`` uint8 from
    ``%010d.jpg`` files: what ``svtpu_torch.cli``'s ``train``, ``encode``
    and ``eval-*`` commands read a frame directory with.

    ``decoder``: "pil" (PIL's bilinear resize, ``workers`` threads),
    "native" (the C++ libjpeg batch decoder of ``svtpu_torch.data.native``
    on ``workers`` threads, built on first use; its bilinear resize differs
    from PIL's antialiased one by a few levels a pixel) or "auto" (native
    where that library is built, else PIL), as ``svtpu``'s ``FrameStore``
    chooses."""

    def __init__(self, frames_dir: str | Path, indices: Sequence[int],
                 resolution: Tuple[int, int] = (256, 256),
                 pattern: str = "{:010d}.jpg", workers: int = 16,
                 decoder: str = "auto"):
        if decoder not in ("auto", "pil", "native"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if decoder == "auto":
            from svtpu_torch.data import native
            decoder = "native" if native.available() else "pil"
        self.decoder = decoder
        self.frames_dir = str(frames_dir)
        self.resolution = resolution
        self.indices = np.asarray(sorted(set(int(i) for i in indices)))
        self._row = {int(f): r for r, f in enumerate(self.indices)}
        paths = [os.path.join(self.frames_dir, pattern.format(i))
                 for i in self.indices]
        if not paths:
            self.array = np.zeros((0, *resolution, 3), np.uint8)
        elif decoder == "native":
            from svtpu_torch.data.native import decode_jpeg_batch
            self.array = decode_jpeg_batch(paths, resolution,
                                           threads=workers)
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                frames = list(ex.map(lambda p: _decode_frame(p, resolution),
                                     paths))
            self.array = np.stack(frames)

    @property
    def item_shape(self):
        return self.array.shape[1:]

    @property
    def dtype(self):
        return self.array.dtype

    def rows(self, frame_indices: np.ndarray) -> np.ndarray:
        flat = np.asarray(frame_indices).reshape(-1)
        rows = np.fromiter((self._row[int(i)] for i in flat), np.int64,
                           len(flat))
        return rows.reshape(np.shape(frame_indices))

    def gather(self, frame_indices: np.ndarray) -> np.ndarray:
        """Frames for an index array of any shape (adds ``[H, W, C]``)."""
        return self.array[self.rows(frame_indices)]


class EmbeddingStore:
    """Precomputed perceptual embeddings (a ``{frame name: [1, C, H, W]}``
    dict or the ``.npy`` file holding one) as ``[N, H, W, C]`` float32."""

    def __init__(self, embeddings, indices: Optional[Sequence[int]] = None):
        if isinstance(embeddings, (str, Path)):
            embeddings = np.load(embeddings, allow_pickle=True).item()
        rows = {}
        for key, emb in embeddings.items():
            stem = os.path.splitext(os.path.basename(str(key)))[0]
            try:
                idx = int(stem)
            except ValueError:
                continue
            e = np.asarray(emb, np.float32)
            e = e.reshape(e.shape[-3:])          # [C, H, W] (drop batch dim)
            rows[idx] = np.transpose(e, (1, 2, 0))  # NHWC
        if indices is not None:
            rows = {i: rows[i] for i in indices}
        self.indices = np.asarray(sorted(rows))
        self._row = {int(f): r for r, f in enumerate(self.indices)}
        self.array = np.stack([rows[i] for i in self.indices]) if rows else \
            np.zeros((0, 0, 0, 4), np.float32)

    item_shape = FrameStore.item_shape
    dtype = FrameStore.dtype
    rows = FrameStore.rows
    gather = FrameStore.gather


class PairBatcher:
    """Epoch iterator over ``[B, 2, S, ...]`` pair batches. The pair table
    is built once; each epoch shuffles its rows."""

    def __init__(self, store, indices_per_state: Sequence[Sequence[int]],
                 batch_size: int, seed: int = 0, shuffle: bool = True):
        self.store = store
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.pair_table = build_pairs(indices_per_state, seed)  # [P, S, 2]
        self.num_pairs = len(self.pair_table)
        self.num_states = self.pair_table.shape[1]

    def num_batches(self) -> int:
        return -(-self.num_pairs // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterable[np.ndarray]:
        for idx in self.epoch_frame_indices(epoch_idx):
            yield self.store.gather(idx)

    def epoch_frame_indices(self, epoch_idx: int) -> Iterable[np.ndarray]:
        """Same batches as :meth:`epoch`, as ``[B, 2, S]`` frame indices."""
        batches = epoch_batches(self.pair_table, self.batch_size,
                                self.seed + 7919 * (epoch_idx + 1),
                                shuffle=self.shuffle)
        for b in batches:                       # [B, S, 2]
            yield np.transpose(b, (0, 2, 1))

    def epoch_indices(self, epoch_idx: int) -> Iterable[np.ndarray]:
        """Row indices into ``store.array`` for gathers on the device; the
        batch order of :meth:`epoch`."""
        for idx in self.epoch_frame_indices(epoch_idx):
            yield self.store.rows(idx).astype(np.int32)


class RandomPairBatcher:
    """Each item draws a fresh random frame pair per state, over a virtual
    ``num_items`` length (the reference's ``SampleStatePairDataset``)."""

    def __init__(self, store, state_segments, batch_size: int,
                 num_items: int = 1000, seed: int = 0):
        self.store = store
        self.batch_size = batch_size
        self.num_items = num_items
        self.seed = seed
        self.state_indices = [np.arange(s, e) for s, e in state_segments]

    def num_batches(self) -> int:
        return -(-self.num_items // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterable[np.ndarray]:
        rng = np.random.default_rng(self.seed + 104729 * (epoch_idx + 1))
        S = len(self.state_indices)
        for _ in range(self.num_batches()):
            idx = np.zeros((self.batch_size, 2, S), np.int64)
            for s, frames in enumerate(self.state_indices):
                if len(frames) == 1:
                    idx[:, :, s] = frames[0]
                else:
                    for b in range(self.batch_size):
                        idx[b, :, s] = rng.choice(frames, 2, replace=False)
            yield self.store.gather(idx)


class SegmentBatcher:
    """Simple-variant data: one item = all frames of one state segment,
    padded to the longest segment. Yields ``[1, T_max, ...]`` and a
    ``[1, T_max]`` validity mask."""

    def __init__(self, store, state_segments: Sequence[Tuple[int, int]],
                 seed: int = 0):
        self.store = store
        self.segments = [np.arange(s, e) for s, e in state_segments]
        self.t_max = max(len(s) for s in self.segments)
        self.seed = seed

    def epoch(self, epoch_idx: int):
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(len(self.segments))
        for i in order:
            seg = self.segments[i]
            pad = self.t_max - len(seg)
            idx = np.concatenate([seg, np.full(pad, seg[-1])]) if pad else seg
            mask = np.concatenate([np.ones(len(seg), np.float32),
                                   np.zeros(pad, np.float32)])
            yield self.store.gather(idx)[None], mask[None]


def make_split_stores(frames_dir, video_meta, resolution=(256, 256),
                      test_pct=0.1, val_pct=0.1):
    """Split a video's states, and one FrameStore of its train, val and
    test frames."""
    splits = split_segments(video_meta.state_segments(), test_pct, val_pct)
    all_idx = (list(splits.flat("train")) + list(splits.flat("val"))
               + list(splits.flat("test")))
    store = FrameStore(frames_dir, all_idx, resolution)
    return store, splits
