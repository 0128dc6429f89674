"""Torch-geometry conv, transposed conv and dense layers with an explicit
compute dtype (``svtpu/ops/conv.py:34-47,148-184,216-228``).

These are XLA ops in the JAX package, so here they stay library calls
(``F.conv2d``, ``F.conv_transpose2d``, ``torch.matmul``). Parameters are held
in torch's layouts (``Conv2d [O, I, kh, kw]``, ``ConvTranspose2d
[I, O, kh, kw]``, ``Linear [out, in]``) with torch's default init, so a
reference state dict loads as it is. Activations inside the model are NCHW
(channels-last memory where they come from an NHWC tensor).

The compute dtype is applied where the reference applies it: inputs and
weights are cast to it, the product is rounded to it, and the bias is added
in it afterwards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv2d_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int, padding: int, dtype) -> torch.Tensor:
    """``nn.Conv2d(k, s, p)`` on NCHW ``x`` in ``dtype``."""
    y = F.conv2d(x.to(dtype), w.to(dtype), None, stride, padding)
    return y + b.to(dtype).view(1, -1, 1, 1)


def conv_transpose2d_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           stride: int, padding: int, output_padding: int,
                           dtype) -> torch.Tensor:
    """``nn.ConvTranspose2d(k, s, p, output_padding)`` on NCHW ``x``."""
    y = F.conv_transpose2d(x.to(dtype), w.to(dtype), None, stride, padding,
                           output_padding)
    return y + b.to(dtype).view(1, -1, 1, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dtype) -> torch.Tensor:
    """``x @ w.T + b`` in ``dtype`` (``w`` in ``nn.Linear``'s layout)."""
    return x.to(dtype) @ w.to(dtype).T + b.to(dtype)


class Conv2dTorch(nn.Conv2d):
    """``nn.Conv2d`` whose forward runs in a given compute dtype."""

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return conv2d_torch(x, self.weight, self.bias, self.stride[0],
                            self.padding[0], dtype)


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose forward runs in a given compute dtype."""

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return conv_transpose2d_torch(x, self.weight, self.bias,
                                      self.stride[0], self.padding[0],
                                      self.output_padding[0], dtype)


class Dense(nn.Linear):
    """``nn.Linear`` whose forward runs in a given compute dtype."""

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return dense(x, self.weight, self.bias, dtype)
