"""Random draws of a global batch, taken at one rank's rows.

A data-parallel rank computes only its rows of a batch, but its noise and
dropout masks must be the ones a single process draws for those rows, so
that the ranks together train the model one device trains. So a rank
draws at the global batch's shape from the generator every rank seeds
alike, and keeps its rows (``GlobalRows``). That costs the global batch's
draws on every rank, and stays exact for any generator and device.

The leading dimension of a drawn tensor may be the batch's rows times a
factor ``k`` (the model flattens ``[B, T]`` into ``B * T`` frames): local
row ``i``'s ``k`` entries are then global row ``rows[i]``'s.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class GlobalRows(NamedTuple):
    """The global row of each local row of a batch, and the global batch's
    row count."""

    rows: torch.Tensor      # int64, one entry a local row
    total: int


class ShardedGenerator(NamedTuple):
    """A generator whose draws are taken at ``rows`` of the global batch."""

    generator: torch.Generator
    rows: GlobalRows

    @property
    def device(self) -> torch.device:
        return self.generator.device


Source = Optional[Union[torch.Generator, ShardedGenerator]]


def sharded(generator: Optional[torch.Generator],
            rows: Optional[GlobalRows]) -> Source:
    """``generator`` drawing at ``rows``; itself where ``rows`` is None."""
    if generator is None or rows is None:
        return generator
    return ShardedGenerator(generator, rows)


def _draw(fn, shape, source: Source, dtype, device) -> torch.Tensor:
    if not isinstance(source, ShardedGenerator):
        return fn(tuple(shape), generator=source, dtype=dtype, device=device)
    gen, (rows, total) = source
    k, rem = divmod(shape[0], len(rows))
    if rem:
        raise ValueError(f"leading dim {shape[0]} is not a multiple of the "
                         f"{len(rows)} local rows")
    full = fn((total * k,) + tuple(shape[1:]), generator=gen, dtype=dtype,
              device=device)
    r = rows.to(device)
    return full[(r[:, None] * k + torch.arange(k, device=device)).reshape(-1)]


def rand(shape, source: Source, dtype=None, device=None) -> torch.Tensor:
    """``torch.rand`` from a generator or a ``ShardedGenerator``."""
    return _draw(torch.rand, shape, source, dtype, device)


def randn(shape, source: Source, dtype=None, device=None) -> torch.Tensor:
    """``torch.randn`` from a generator or a ``ShardedGenerator``."""
    return _draw(torch.randn, shape, source, dtype, device)
