"""Tracing and profiling utilities (``svtpu/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is a card, CUDA activities, written into ``logdir`` as a Chrome
    trace that TensorBoard's profiler plugin and Perfetto read.
  * ``sync``: wait for everything queued before a tensor by reading one of
    its elements on the host.
  * ``StepTimer``: wall-clock step times with warm-up discard and a
    percentile summary.
  * ``device_memory_stats``: the caching allocator's byte counters of each
    card.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the ``torch.profiler.profile``, whose
    ``key_averages()`` and ``events()`` the caller may read after it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Force everything queued before ``x`` (a tensor, or a dict, list or
    tuple holding one) by reading one element of its first tensor."""
    t = _first_tensor(x)
    if t is not None and t.numel():
        t.reshape(-1)[0].item()


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)), "steps": len(a)}


def device_memory_stats(devices: Optional[Sequence[int]] = None
                        ) -> Dict[str, Dict[str, int]]:
    """``torch.cuda.memory_stats`` of each card in ``devices`` (all of them
    by default), its byte counters only, by ``"cuda:<i>"``. Empty where
    there is no card or CUDA is not initialised: it starts no context."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out = {}
    for d in (range(torch.cuda.device_count()) if devices is None
              else devices):
        s = torch.cuda.memory_stats(d)
        if s:
            out[f"cuda:{d}"] = {k: int(v) for k, v in s.items()
                                if "bytes" in k}
    return out
