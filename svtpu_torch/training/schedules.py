"""Temperature schedule (``svtpu/training/schedules.py:7-22``)."""
from __future__ import annotations

import math


def temperature_schedule(step: int, init: float, final: float,
                         anneal_rate: float,
                         num_steps_to_update: int) -> float:
    """Gated exponential annealing: the temperature changes only at steps
    that are multiples of ``num_steps_to_update`` and holds in between;
    steps before the first update keep ``init``. Steps are 1-based (the
    reference increments its global step before reading the schedule).

    A host int in, a Python float out: the port's step counter lives on the
    host, so the temperature of every step is known there.
    """
    n = max(int(num_steps_to_update), 1)
    last_update = (int(step) // n) * n
    if last_update == 0:
        return float(init)
    return max(float(final), init * math.exp(-anneal_rate * last_update))
