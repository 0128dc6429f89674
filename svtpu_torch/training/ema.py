"""Parameter EMA and the SD warmup LR schedule (``svtpu/training/ema.py``).

  * ``LitEma`` (``ldm/modules/ema.py``): an exponential moving average of
    the parameters with the warmup-capped decay
    ``min(decay, (1 + updates) / (10 + updates))``.
  * ``LambdaLinearScheduler`` (``ldm/lr_scheduler.py``): linear warmup,
    then a constant factor.

The averages are tensors on the parameters' device, updated in place by one
``torch._foreach_lerp_``; the decay comes from the update count, a host int,
so an update never reads a card tensor on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class EmaState(NamedTuple):
    ema: Dict[str, torch.Tensor]
    updates: int


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def ema_init(params: Params) -> EmaState:
    """A copy of the parameters (a module's, or a name → tensor mapping),
    on their devices and in their dtypes."""
    return EmaState(ema={k: v.detach().clone()
                         for k, v in _named(params).items()}, updates=0)


def ema_update(state: EmaState, params: Params,
               decay: float = 0.9999) -> EmaState:
    """One EMA step with LitEma's warmup cap: ``ema -= (1 - d) * (ema - p)``.
    Updates ``state.ema``'s tensors in place and returns the state with one
    more update."""
    updates = state.updates + 1
    d = min(decay, (1.0 + updates) / (10.0 + updates))
    new = _named(params)
    keys = list(state.ema)
    ema = [state.ema[k] for k in keys]
    with torch.no_grad():
        torch._foreach_lerp_(ema, [new[k].detach().to(e.dtype)
                                   for k, e in zip(keys, ema)], 1.0 - d)
    return EmaState(ema=state.ema, updates=updates)


def lambda_linear_schedule(base_lr: float, warmup_steps: int,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0) -> Callable[[int], float]:
    """``step → lr``: linear warmup ``f_start → f_max`` over
    ``warmup_steps``, then constant ``f_min`` (the v1 config's
    LambdaLinearScheduler shape), times ``base_lr``. Divided by
    ``base_lr`` it is a ``torch.optim.lr_scheduler.LambdaLR`` factor."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (f_start + (f_max - f_start) * min(
                step / max(warmup_steps, 1), 1.0))
        return base_lr * f_min

    return schedule
