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

``Replicas`` are generators made once and seeded alike before each train
step, which a CUDA graph of the step can hold (the trainer's
``StepGenerators``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class GlobalRows(NamedTuple):
    """The global row of each local row of a batch, and the global batch's
    row count. ``rows`` lies on the device of the draws: a copy from the
    host at every draw would make the host wait, and a CUDA graph cannot
    hold it."""

    rows: torch.Tensor      # int64, one entry a local row
    total: int


class Replicas:
    """Generators on ``device`` that are seeded alike: ``seed(s)`` seeds
    each with ``s``, and ``take()`` hands them out in turn (making one more
    where all are taken), so every taker draws what a fresh generator seeded
    with ``s`` draws. A conv stack under ``remat`` draws its dropout masks
    twice a step, in its forward and in the recompute of the backward: two
    replicas give both the same masks, as a fresh generator a call gives
    them, and a CUDA graph of the step holds both (it cannot seed a
    generator midway)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.generators: list = []
        self.seed(seed)

    def seed(self, s: int) -> None:
        self._seed, self._taken = int(s), 0
        for g in self.generators:
            g.manual_seed(self._seed)

    def take(self) -> torch.Generator:
        if self._taken == len(self.generators):
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed)
            self.generators.append(g)
        self._taken += 1
        return self.generators[self._taken - 1]


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
    if rows.device != full.device:
        raise ValueError(f"global rows on {rows.device}, draws on "
                         f"{full.device}: put the rows on the draws' device "
                         f"once")
    return full[(rows[:, None] * k
                 + torch.arange(k, device=device)).reshape(-1)]


def rand(shape, source: Source, dtype=None, device=None) -> torch.Tensor:
    """``torch.rand`` from a generator or a ``ShardedGenerator``."""
    return _draw(torch.rand, shape, source, dtype, device)


def randn(shape, source: Source, dtype=None, device=None) -> torch.Tensor:
    """``torch.randn`` from a generator or a ``ShardedGenerator``."""
    return _draw(torch.randn, shape, source, dtype, device)
