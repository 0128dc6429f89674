"""Stacked unidirectional LSTM (``svtpu/ops/lstm.py:26-85``).

Gate order i, f, g, o (torch's); the input projection of each layer is
hoisted out of the recurrence into one ``[B*T, D] @ [D, 4H]`` matmul; the
two biases are summed once in float32 and then cast, as the reference folds
them; the carry lives in the compute dtype. ``residual`` adds an identity
path around every width-preserving layer.

Parameters are held by an ``nn.LSTM`` child named ``lstm`` — torch's init
and the reference's state-dict names (``lstm.weight_ih_l{k}`` ...) — but
the recurrence is computed here, so the residual path and the compute-dtype
casts follow the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn


class LSTM(nn.Module):
    """``[B, T, D]`` → ``[B, T, H]``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 residual: bool = False, dtype=torch.float32):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers,
                            batch_first=True)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.residual = residual
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        H, dt = self.hidden_size, self.dtype
        h = x.to(dt)
        for k in range(self.num_layers):
            w_ih = getattr(self.lstm, f"weight_ih_l{k}")
            w_hh = getattr(self.lstm, f"weight_hh_l{k}").to(dt).T
            bias = (getattr(self.lstm, f"bias_ih_l{k}")
                    + getattr(self.lstm, f"bias_hh_l{k}"))
            d_in = h.shape[-1]
            gates_x = (h.reshape(B * T, d_in) @ w_ih.to(dt).T
                       + bias.to(dt)).reshape(B, T, 4 * H)
            h_t = torch.zeros(B, H, dtype=dt, device=x.device)
            c_t = torch.zeros(B, H, dtype=dt, device=x.device)
            outs = []
            for t in range(T):
                g = gates_x[:, t] + h_t @ w_hh
                i, f, gc, o = g.chunk(4, dim=-1)
                c_t = torch.sigmoid(f) * c_t + torch.sigmoid(i) * torch.tanh(gc)
                h_t = torch.sigmoid(o) * torch.tanh(c_t)
                outs.append(h_t)
            out = torch.stack(outs, dim=1)
            h = h + out if (self.residual and d_in == H) else out
        return h
