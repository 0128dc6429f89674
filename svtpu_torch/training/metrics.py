"""Metrics logging (``svtpu/training/metrics.py:10-40``): TensorBoard scalars
per batch and per epoch; W&B optional. Both are logging, not compute, and
become no-ops when their package is absent."""
from __future__ import annotations

from typing import Mapping, Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str] = None,
                 use_wandb: bool = False, wandb_config: Optional[dict] = None):
        self._tb = None
        self._wandb = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:
                self._tb = None
        if use_wandb:
            try:
                import wandb
                if wandb.run is None:
                    wandb.init(config=wandb_config or {})
                self._wandb = wandb
            except ImportError:
                self._wandb = None

    def scalars(self, prefix: str, values: Mapping[str, float], step: int):
        for k, v in values.items():
            if self._tb:
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        if self._wandb:
            self._wandb.log({f"{prefix}/{k}": float(v)
                             for k, v in values.items()}, step=step)

    def close(self):
        if self._tb:
            self._tb.close()
