"""What the port's CUDA graphs share: the route rule, the eager run on a
side stream, the capture that names its first cause, and the kernel
launch counts that a replay keeps.

Two kinds of graph use these: the train step (``training/step_graph.py``)
and the serving encodes (``models/encode_graph.py``). Both stand for a
``jax.jit`` of ``svtpu``: the host records the device work once and then
launches it as one graph.

Launch counts. Each kernel wrapper counts its launches in Python where it
launches (``<wrapper>.launches``). A capture calls the wrappers but runs
nothing, and a replay runs the kernels without calling them. So
``capture`` takes back what the wrappers counted during the capture and
returns it as the graph's launches; the owner adds them again at every
replay (``Launches.add``). The counts then equal the kernels that ran.
"""
from __future__ import annotations

import traceback
from typing import Callable, Iterable, Optional

import torch

from svtpu_torch.utils.profiling import span


def graph_route(device, mesh=None) -> str:
    """``"graph"`` on a CUDA device whose mesh (if any) has no "model" axis;
    ``"eager"`` on the CPU, where CUDA graphs do not exist, and under a
    "model" axis, whose tensor-parallel fc layers are ``DTensor``s."""
    if torch.device(device).type != "cuda":
        return "eager"
    if mesh is not None and "model" in mesh.axis_names:
        return "eager"
    return "graph"


def kernel_counters() -> tuple:
    """The four kernel wrappers, each counting its launches."""
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete

    return (fused_conv01, lstm_binary_concrete, binary_concrete_fused,
            flash_attention)


class Launches:
    """Launch counters: objects with an int ``.launches`` and, where they
    have one, a ``.launches_by_kernel`` dict of ints. A reading is a list
    of ``(launches, by_kernel)`` pairs, one a counter."""

    def __init__(self, counters: Optional[Iterable] = None):
        self.counters = tuple(kernel_counters() if counters is None
                              else counters)

    def read(self) -> list:
        return [(c.launches, dict(getattr(c, "launches_by_kernel", {})))
                for c in self.counters]

    def since(self, before: list) -> list:
        """What each counter counted since the reading ``before``."""
        return [(n - n0, {k: v - by0.get(k, 0) for k, v in by.items()})
                for (n, by), (n0, by0) in zip(self.read(), before)]

    def add(self, delta: list, sign: int = 1) -> None:
        for c, (n, by) in zip(self.counters, delta):
            c.launches += sign * n
            for k, v in by.items():
                c.launches_by_kernel[k] += sign * v


def on_side_stream(fn: Callable[[], torch.Tensor], device) -> torch.Tensor:
    """``fn()`` run eagerly on a side stream, ordered after and before the
    current stream's work: the warm-up before a capture, which builds what
    a capture cannot (the kernels' libraries, cuBLAS's and cuDNN's plans,
    Adam's moments, NCCL's communicator). Returns ``fn``'s tensor."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    out.record_stream(main)
    return out


def pool_bytes(graph: torch.cuda.CUDAGraph) -> Optional[int]:
    """The bytes of the segments in ``graph``'s private memory pool, from
    the caching allocator's snapshot; None where it names no pools."""
    pool = tuple(graph.pool())
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == pool)


def capture(body: Callable[[], torch.Tensor], generators: Iterable,
            device, error: type, what: str, consequence: str,
            launches: Launches):
    """Capture ``body()`` as a CUDA graph with a private memory pool.

    ``generators`` are registered with the graph: a replay reads their
    seeds and offsets when it starts. The capture is "thread_local", so
    another thread may copy to the card meanwhile. Returns ``(graph, out,
    delta)``: ``out`` is the graph's static output, which every replay
    overwrites, and ``delta`` the launches the capture counted, taken back
    from ``launches`` (a replay adds them). A failure raises ``error``
    naming the first cause's file and line, ``what`` failed and
    ``consequence``; nothing runs eagerly in the graph's place.
    """
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = launches.read()
    try:
        with span("svtpu.graph.capture"), torch.cuda.device(device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
    except Exception as e:  # noqa: BLE001 — named and re-raised
        launches.add(launches.since(before), -1)
        # The first error of the chain is the body's own; the capture's end
        # fails after it.
        cause = e
        while cause.__context__ is not None:
            cause = cause.__context__
        where = traceback.extract_tb(cause.__traceback__)[-1]
        raise error(
            f"capturing {what} as a CUDA graph failed at "
            f"{where.filename}:{where.lineno} ({where.line}): "
            f"{type(cause).__name__}: {str(cause).splitlines()[0]}; "
            f"{consequence}") from e
    delta = launches.since(before)
    launches.add(delta, -1)
    return graph, out, delta
