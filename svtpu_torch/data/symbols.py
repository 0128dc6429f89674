"""Bit-packed binary-symbol storage — the port's own copy of
``svtpu/data/symbols.py``, for the codes the pipeline emits.

Packs one *bit* per latent dimension; the npz round-trips frame ids and
state labels alongside, and is readable by either package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """``[N, D]`` {0,1} → ``[N, ceil(D/8)]`` uint8 (little-endian bits)."""
    codes = np.asarray(codes).astype(np.uint8)
    return np.packbits(codes, axis=-1, bitorder="little")


def unpack_codes(packed: np.ndarray, dim: int) -> np.ndarray:
    """Inverse of :func:`pack_codes` for latent width ``dim``."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1,
                         bitorder="little")
    return bits[..., :dim]


class SymbolStore:
    """Packed binary codes with frame ids and optional state labels."""

    def __init__(self, codes: np.ndarray, frame_ids: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 packed: Optional[np.ndarray] = None,
                 dim: Optional[int] = None):
        if packed is not None:
            self.packed = np.asarray(packed, np.uint8)
            self.dim = int(dim)
        else:
            codes = np.asarray(codes)
            self.packed = pack_codes(codes)
            self.dim = int(codes.shape[-1])
        self.frame_ids = np.asarray(frame_ids, np.int64)
        if len(self.frame_ids) != len(self.packed):
            raise ValueError("frame_ids and codes disagree on length")
        self.labels = (np.asarray(labels, np.int32)
                       if labels is not None else None)
        self._id_to_row = {int(f): i for i, f in enumerate(self.frame_ids)}

    def __len__(self) -> int:
        return len(self.packed)

    @property
    def codes(self) -> np.ndarray:
        """Unpacked ``[N, dim]`` uint8 codes."""
        return unpack_codes(self.packed, self.dim)

    def code_of(self, frame_id: int) -> np.ndarray:
        """Code for one frame id."""
        return unpack_codes(self.packed[self._id_to_row[int(frame_id)]],
                            self.dim)

    def save(self, path) -> None:
        arrays = {"packed": self.packed, "frame_ids": self.frame_ids,
                  "dim": np.int64(self.dim)}
        if self.labels is not None:
            arrays["labels"] = self.labels
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path) -> "SymbolStore":
        with np.load(path) as z:
            labels = z["labels"] if "labels" in z.files else None
            return cls(None, z["frame_ids"], labels=labels,
                       packed=z["packed"], dim=int(z["dim"]))
