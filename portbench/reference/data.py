"""What a train step of the flagship recipe draws from its seeds, worked out
again for the reference: the video's splits, the pair table and each
epoch's batches, the temperature of each step, and the seeds of each
step's noise and dropout masks.

These follow the recipe as the reference repository defines it (a middle
chunk of every state for test and val; pairs of frames within a state; a
seeded shuffle an epoch; gated exponential annealing) and the seeding rule
of the port's train step (``batch_seed`` of the run's seed and the step,
one generator a pass and conv stack). Plain Python and NumPy; nothing of
the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def batch_seed(seed: int, index: int) -> int:
    """SplitMix64's finaliser of ``(seed mod 2^32, index mod 2^32)``."""
    x = (((int(seed) & _M32) << 32 | (int(index) & _M32))
         + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold(key: int, i: int) -> int:
    """``batch_seed`` of a 64-bit key, both halves folded in."""
    return batch_seed((key ^ (key >> 32)) & _M32, i)


def state_segments(video: dict) -> list[tuple[int, int]]:
    flags, g = video["flags"], video["grey_out"]
    segs = [(0, flags[0] - g)]
    segs += [(flags[i - 1] + g + 1, flags[i] - g)
             for i in range(1, len(flags))]
    segs.append((flags[-1] + g + 1, video["last_frame"] + 1))
    return segs


def splits(video: dict) -> dict:
    """Per state: the middle ``test + val`` share (test first), the rest
    train."""
    out = {"train": [], "val": [], "test": []}
    tp, vp = video["test_pct"], video["val_pct"]
    for start, end in state_segments(video):
        full = list(range(start, end))
        n = len(full)
        tv = int(n * (tp + vp))
        margin = (n - tv) // 2
        mid = full[margin:margin + tv]
        out["train"].append(full[:margin] + full[margin + tv:])
        nt = int(round(tp / (tp + vp) * tv)) if tv else 0
        out["test"].append(mid[:nt])
        out["val"].append(mid[nt:])
    return out


def state_of(frame: int, flags) -> int:
    return sum(frame >= f for f in flags)


def pair_table(per_state, seed: int) -> np.ndarray:
    """``[pairs, states, 2]``: each state's frames padded to the longest
    state by resampling, shuffled, cut into pairs (an odd one out paired
    with another frame of its state), every state's pairs tiled to the
    most pairs."""
    rng = np.random.default_rng(seed)
    longest = max(len(s) for s in per_state)
    pairs_of = []
    for idx in per_state:
        idx = np.asarray(idx)
        padded = idx.copy() if len(idx) == longest else np.concatenate(
            [idx, rng.choice(idx, size=longest - len(idx), replace=True)])
        rng.shuffle(padded)
        n = len(padded) // 2
        pairs = padded[:2 * n].reshape(n, 2)
        if len(padded) % 2:
            last = padded[-1]
            others = [x for x in idx if x != last]
            mate = rng.choice(np.asarray(others)) if others else last
            pairs = np.concatenate([pairs, [[last, mate]]], axis=0)
        pairs_of.append(pairs)
    most = max(len(p) for p in pairs_of)
    out = np.zeros((most, len(per_state), 2), np.int32)
    for s, p in enumerate(pairs_of):
        out[:, s] = np.tile(p, (-(-most // len(p)), 1))[:most]
    return out


def epoch_batches(table: np.ndarray, batch: int, seed: int) -> np.ndarray:
    """``[batches, batch, 2, states]`` frame ids of one epoch: the table
    shuffled, padded to whole batches by resampling rows."""
    rng = np.random.default_rng(seed)
    n = len(table)
    order = rng.permutation(n)
    pad = (-n) % batch
    if pad:
        order = np.concatenate([order, rng.choice(n, pad)])
    return np.transpose(table[order].reshape(-1, batch, *table.shape[1:]),
                        (0, 1, 3, 2))


def step_batches(video: dict, batch: int, seed: int, steps: int):
    """Frame ids ``[batch, 2, states]`` of the run's first ``steps`` steps
    (epochs in order, each epoch's batches in order)."""
    table = pair_table(splits(video)["train"], seed)
    out, epoch = [], 0
    while len(out) < steps:
        out += list(epoch_batches(table, batch, seed + 7919 * (epoch + 1)))
        epoch += 1
    return out[:steps]


def temperature(step: int, t: dict) -> float:
    """The temperature of 1-based step ``step``: ``init`` until the first
    multiple of ``num_steps_to_update``, then ``init * exp(-rate * last
    update)``, never below ``final``."""
    n = max(int(t["num_steps_to_update"]), 1)
    last = (step // n) * n
    if last == 0:
        return float(t["init_temperature"])
    return max(float(t["final_temperature"]),
               t["init_temperature"] * math.exp(-t["anneal_rate"] * last))


class StepDraws:
    """The random draws of train step ``step`` of a run seeded ``seed``:
    pass ``k`` (0 the pair pass, 1 the context-free pass) draws its noise
    uniforms from a generator seeded ``fold(key, 2k)``, in the compute
    dtype, and its dropout masks from one generator a conv stack (0 the
    encoder's, 1 the decoder's) seeded ``batch_seed(fold(key, 2k + 1),
    stack)``, where ``key = batch_seed(seed + 1, step)``."""

    def __init__(self, seed: int, step: int, device, dtype):
        self.key = batch_seed(seed + 1, step)
        self.device, self.dtype = device, dtype

    def _gen(self, s: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(s)
        return g

    def noise(self, k: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(
            fold(self.key, 2 * k)), dtype=self.dtype,
            device=self.device).float()

    def dropout(self, k: int, stack: int) -> torch.Generator:
        return self._gen(batch_seed(fold(self.key, 2 * k + 1), stack))
