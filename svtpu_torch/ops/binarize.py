"""Binarization primitives: Binary-Concrete and binary Gumbel-Softmax
(``svtpu/ops/binarize.py:22-86``).

Noise comes from an explicit ``torch.Generator`` (in place of a JAX key; or
a ``draws.ShardedGenerator``, one data-parallel rank's rows of it) or
from an injected uniform tensor ``u`` — the latter lets a test feed the JAX
package and the port the same random numbers. With neither, the path is
deterministic. As in the reference, ``u`` and all the arithmetic are in the
logits' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from svtpu_torch.ops import draws


def _uniform(shape, like: torch.Tensor, generator: draws.Source,
             u: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if u is not None:
        return u.to(device=like.device, dtype=like.dtype)
    if generator is not None:
        return draws.rand(shape, generator, like.dtype, like.device)
    return None


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A Python or tensor scalar in ``like``'s dtype (the reference casts
    temperature and noise scale to the logits' dtype before using them). A
    Python number is filled in on the device: a copy from the host would
    make the host wait for the card."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), v, dtype=like.dtype, device=like.device)


def logistic_noise(u: torch.Tensor, eps: float) -> torch.Tensor:
    """``log(U + eps) - log(1 - U + eps)``."""
    return torch.log(u + eps) - torch.log(1.0 - u + eps)


def binary_concrete(logits: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    temperature=0.5, hard: bool = False, eps: float = 1e-8,
                    noise_scale=1.0, *,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = sigmoid((logits + noise_scale * logistic) / temperature)``;
    if ``hard``, straight-through-discretized at 0.5."""
    u = _uniform(logits.shape, logits, generator, u)
    if u is not None:
        logits = logits + _scalar(noise_scale, logits) * logistic_noise(u, eps)
    y = torch.sigmoid(logits / _scalar(temperature, logits))
    if hard:
        y_hard = (y > 0.5).to(y.dtype)
        y = y + (y_hard - y).detach()
    return y


def gumbel_softmax_binary(logits2: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          temperature=1.0, hard: bool = False,
                          eps: float = 1e-10, *,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2-category Gumbel-Softmax over the last axis of ``[..., 2]``."""
    u = _uniform(logits2.shape, logits2, generator, u)
    if u is not None:
        logits2 = logits2 + (-torch.log(-torch.log(u + eps) + eps))
    y = torch.softmax(logits2 / _scalar(temperature, logits2), dim=-1)
    if hard:
        y_hard = (y == y.max(dim=-1, keepdim=True).values).to(y.dtype)
        y = y + (y_hard - y).detach()
    return y
