"""The train step as one CUDA graph: the counterpart of ``svtpu``'s
``jax.jit`` of its step and ``lax.scan`` of a staged epoch
(``svtpu/training/trainer.py:403-471``).

``svtpu`` compiles the step into one device program. The port captures the
step's device work (forward, backward, the data axis's gradient all-reduce
and Adam) as a CUDA graph once for each train state, and replays it at
every step: the host launches one graph a step in place of every op. What
changes from step to step reaches the graph through memory it holds:

  * the batch (row indices into the device bank, or frames) is copied into
    a static buffer before each replay;
  * the temperature lies in a 0-dim tensor that the trainer writes before
    each step: a Python number would be baked into the graph as the
    captured step's;
  * the step's generators are persistent (``trainer.StepGenerators``) and
    seeded before each step; a replay reads their seeds and offsets when it
    starts (``CUDAGraph.register_generator_state``).

Protocol: a state's first ``WARMUP_STEPS`` steps run eagerly on a side
stream. They are real steps, and they make what a capture cannot: Adam's
moments, cuBLAS's and cuDNN's handles and plans, NCCL's communicator. The
next step is captured, which executes nothing, and replayed at once, with
its own step count, temperature and seeds; every later step is a replay. A
model or optimizer built anew (a restart, ``init_state``, a sweep trial)
comes with a new state, which is captured anew. Each graph holds a private
memory pool, freed with the graph: two live states of one trainer never
share a pool, where a replay of one could overwrite the other's tensors.

Which route a trainer takes follows from its device and mesh
(``ops/cuda_graph.graph_route``). A capture that fails raises
``StepCaptureError``: the trainer does not train eagerly in its place. The warm-up, the capture and
the launch counts are ``ops/cuda_graph.py``'s, which the serving encodes'
graphs share.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from svtpu_torch.ops import cuda_graph

# Eager steps of a state before its capture.
WARMUP_STEPS = 2


class StepCaptureError(RuntimeError):
    """The train step could not be captured as a CUDA graph."""


class StepGraph:
    """One train state's step as a CUDA graph.

    ``body(batch)`` is the step's device work (``Trainer._step_body`` bound
    to the state's model and optimizer); it returns the step's metric
    vector. ``generators()`` lists every generator the body draws from.
    Calling the graph with a batch runs one step and returns the metric
    vector: a warm-up step's own, or the graph's static output, which the
    next step overwrites. ``captures`` and ``replays`` count, over the
    process, the graphs captured and the steps replayed.
    """

    captures = 0
    replays = 0

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor],
                 generators: Callable[[], list], device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise StepCaptureError(
                f"a CUDA graph of the train step needs a CUDA device, not "
                f"{self.device}; on the CPU the step runs eagerly")
        self.body = body
        self.generators = generators
        self.eager_steps = 0
        self.graph = None
        self.batch = None       # the static input
        self.out = None         # the static output
        self.capture_s = None   # host seconds of the capture
        self.launches = cuda_graph.Launches()
        self.delta = None       # the kernel launches of one replay

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            return self._warm_up(batch)
        if self.graph is None:
            self._capture(batch)
        else:
            if batch.shape != self.batch.shape:
                raise ValueError(
                    f"the train step's graph was captured for batches of "
                    f"shape {tuple(self.batch.shape)}, not "
                    f"{tuple(batch.shape)}")
            self.batch.copy_(batch)
        self.graph.replay()
        self.launches.add(self.delta)
        StepGraph.replays += 1
        return self.out

    def _warm_up(self, batch: torch.Tensor) -> torch.Tensor:
        out = cuda_graph.on_side_stream(lambda: self.body(batch), self.device)
        self.eager_steps += 1
        return out

    def _capture(self, batch: torch.Tensor) -> None:
        t0 = time.perf_counter()
        self.batch = batch.clone()
        self.graph, self.out, self.delta = cuda_graph.capture(
            lambda: self.body(self.batch), self.generators(), self.device,
            StepCaptureError, "the train step",
            "the step does not run eagerly in its place", self.launches)
        self.capture_s = time.perf_counter() - t0
        StepGraph.captures += 1
