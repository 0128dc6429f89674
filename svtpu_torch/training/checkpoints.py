"""Checkpointing, best-by-metric (``svtpu/training/checkpoints.py:20-91``),
with ``torch.save`` in place of orbax.

A checkpoint is a ``.pt`` file of a tree of tensors (the trainer saves the
model's and the optimizer's state dicts) and a ``.json`` of its meta: the
epoch, the metric and whatever the caller adds (the trainer: the selection
key, the best metric and key so far, the Hamming vector and the global
step, which ``Trainer.train(resume=True)`` reads back).

``save_params_npz`` (``svtpu/training/checkpoints.py:94-108``) exports a
model's weights in ``svtpu``'s single-file layout, which both packages'
``load_params_npz`` read.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class BestCheckpointer:
    """Keeps the best checkpoint (by a scalar metric, or lexicographically
    by a selection key) plus the latest one."""

    def __init__(self, directory: str | Path, mode: str = "max"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.mode = mode
        self.best_metric: Optional[float] = None
        # The trainer's (signed metric, det consistency, mean separation,
        # epoch): a run whose scalar metric never improves still promotes
        # its most converged epoch.
        self.best_key: Optional[tuple] = None

    def _is_better(self, metric: float,
                   sel_key: Optional[tuple] = None) -> bool:
        if sel_key is not None:
            return self.best_key is None or tuple(sel_key) > self.best_key
        if self.best_metric is None:
            return True
        return (metric > self.best_metric if self.mode == "max"
                else metric < self.best_metric)

    def save(self, tree: Any, *, epoch: int, metric: float,
             sel_key: Optional[tuple] = None,
             extra: Optional[dict] = None) -> bool:
        """Save ``latest``; promote it to ``best`` if the metric improved
        (lexicographically on ``sel_key`` when given, else strictly).
        Returns True if it became the new best."""
        meta = {"epoch": int(epoch), "metric": float(metric),
                **(extra or {})}
        # One device→host copy, shared by both writes.
        host_tree = _to_host(tree)
        self._write(host_tree, meta, "latest")
        if self._is_better(metric, sel_key):
            self.best_metric = float(metric)
            if sel_key is not None:
                self.best_key = tuple(sel_key)
            self._write(host_tree, meta, "best")
            return True
        return False

    def _write(self, host_tree, meta, name):
        torch.save(host_tree, self.directory / f"{name}.pt")
        (self.directory / f"{name}.json").write_text(json.dumps(meta))

    def restore(self, name: str = "best"):
        """``(tree, meta)`` of a checkpoint; tensors on the CPU."""
        tree = torch.load(self.directory / f"{name}.pt", map_location="cpu",
                          weights_only=True)
        meta = json.loads((self.directory / f"{name}.json").read_text())
        return tree, meta

    def exists(self, name: str = "best") -> bool:
        return (self.directory / f"{name}.pt").exists()


def save_params_npz(state_dict, cfg, path: str | Path) -> None:
    """A port model's state dict → ``svtpu``'s npz export: its
    ``{"params": ...}`` tree (``models.convert.to_jax_params``) under
    '/'-joined keys, compressed, as ``svtpu``'s ``save_params_npz``
    writes it (e.g. ``results/p_hardened_params.npz``)."""
    from svtpu_torch.models.convert import to_jax_params

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk(to_jax_params(state_dict, cfg), "")
    np.savez_compressed(path, **flat)
