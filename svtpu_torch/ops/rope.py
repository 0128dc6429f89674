"""The 3-D rotary position embedding of V-JEPA 2's encoder
(``facebookresearch/vjepa2``; ``rotate_queries_or_keys`` and
``VJEPA2RopeAttention.apply_rotary_embeddings`` in transformers'
``modeling_vjepa2.py``), applied to the queries and keys of every head.

A head of width D is cut into three blocks of ``2 * ((D // 3) // 2)``
dims, rotated by the token's frame, row and column index in turn (tokens
are ordered (t, h, w)); the dims after them pass through unrotated. Within
a block of width 2m, ``omega_i = 10000^(-i/m)`` for i < m, and ``out = x *
cos + rot(x) * sin`` with ``rot(x)[2j] = -x[2j+1]``, ``rot(x)[2j+1] =
x[2j]``. The published code tiles the angles as ``[omega_0 .. omega_{m-1},
omega_0 .. omega_{m-1}]`` over the block (``emb_sin.repeat(1, 1, 1, 2)``),
so dims 2j and 2j+1 take omega at ``2j mod m`` and ``(2j+1) mod m``; so
do these tables.

The published code recomputes the angles at every call in the inputs'
dtype. ``rope_tables`` builds them once, in float32, over the whole head
(cos 1 and sin 0 on the unrotated tail), and the model keeps them on its
device; ``apply_rope`` rotates in float32 and rounds once to the inputs'
dtype. ``rope_tables.builds`` counts the tables built in the process.
"""
from __future__ import annotations

import torch

THETA = 10000.0


def rope_block(head_dim: int) -> int:
    """Width of each of the three rotated blocks of a head."""
    return 2 * ((head_dim // 3) // 2)


def rope_tables(grid: tuple, head_dim: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[N, head_dim]`` float32 for the ``N = t * h * w``
    tokens of a ``(t, h, w)`` grid, in the (t, h, w) order."""
    t, h, w = grid
    block = rope_block(head_dim)
    omega = torch.arange(block // 2, dtype=torch.float32, device=device)
    omega /= block / 2.0
    omega = 1.0 / THETA ** omega
    ids = torch.arange(t * h * w, device=device)
    pos = (ids // (h * w), ids % (h * w) // w, ids % w)
    cos, sin = [], []
    for p in pos:
        freq = p[:, None] * omega
        cos.append(freq.cos().repeat(1, 2))
        sin.append(freq.sin().repeat(1, 2))
    rest = head_dim - 3 * block
    cos.append(torch.ones((len(ids), rest), device=device))
    sin.append(torch.zeros((len(ids), rest), device=device))
    rope_tables.builds += 1
    return torch.cat(cos, 1), torch.cat(sin, 1)


rope_tables.builds = 0


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x [B, N, heads, D]`` rotated by the tables ``[N, D]`` of its
    tokens, in float32, in ``x``'s dtype."""
    xf = x.float()
    rot = torch.stack((-xf[..., 1::2], xf[..., 0::2]), -1).flatten(-2)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)
