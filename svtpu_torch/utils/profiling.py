"""Tracing and profiling utilities (``svtpu/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is a card, CUDA activities, written into ``logdir`` as a Chrome
    trace that TensorBoard's profiler plugin and Perfetto read.
  * ``span(name)``: a ``record_function`` span of the program, in the same
    trace as the device's events and on its clock, while a profiler runs;
    otherwise a shared no-op context, so a span costs one check.
  * ``sync``: wait for everything queued before a tensor by reading one of
    its elements on the host.
  * ``device_memory_stats``: the caching allocator's byte counters of each
    card.

Spans are named ``svtpu.<layer>.<what>``. A name ends in ``.wait`` where,
and only where, the host blocks on the card: a synchronous copy in, a
readback. The spans of one request or one epoch nest under its outermost
span on the same thread. No span lies inside a captured CUDA graph's body:
a replay runs no host code, so it would fire at the capture alone.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A ``torch.profiler.record_function`` span named ``name`` over a
    ``with`` block while a profiler runs; otherwise one shared
    ``nullcontext``: a ``record_function`` costs microseconds to enter and
    leave even with no profiler running."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
