"""Host → device input prefetching (``svtpu/data/prefetch.py:23-56``).

A background thread gathers the next host batches and, on the card, copies
each from pinned host memory on a side CUDA stream with ``non_blocking``,
recording an event; the consumer's stream waits on that event before the
batch is used, so the copy rides under the current step's kernels. On the
CPU the batches pass through as tensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_END = object()


def prefetch_to_device(iterator: Iterable, device,
                       depth: int = 2) -> Iterator[torch.Tensor]:
    """Yield a tensor on ``device`` for each host ``np.ndarray`` batch,
    ``depth`` batches ahead. An exception raised by ``iterator`` reaches
    the consumer where the failing batch would have been yielded."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(item):
        host = torch.from_numpy(np.ascontiguousarray(item))
        if side is None:
            return host.to(device), None
        with torch.cuda.stream(side):
            t = host.pin_memory().to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return t, event

    def worker():
        try:
            for item in iterator:
                q.put(("ok", place(item)))
        except BaseException as e:  # noqa: BLE001 — the consumer re-raises
            q.put(("err", e))
            return
        q.put(("end", _END))

    threading.Thread(target=worker, daemon=True,
                     name="svtpu-torch-prefetch").start()
    while True:
        kind, val = q.get()
        if kind == "err":
            raise val
        if kind == "end":
            return
        t, event = val
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            # Allocated on the side stream, used on this one.
            t.record_stream(stream)
        yield t
