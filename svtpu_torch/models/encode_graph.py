"""The serving encodes as CUDA graphs: the counterpart of ``svtpu``'s
``jax.jit`` of each encode (``svtpu/pipeline.py:82,97``,
``svtpu/perceptual/embed.py:83,90``, ``svtpu/evaluation/common.py:56``,
``svtpu/training/trainer.py:562,568``).

``svtpu`` compiles an encode once for each input shape and set of static
flags, and traces the rest (the temperature, the noise ratio, the key).
The port records an encode's device work as a CUDA graph once for each
key and replays it at every later call with that key. A key is the
caller's tag and static flags (``hard``, ``noise``), the inputs' shapes
and dtypes, and the module whose parameters the
graph reads (their addresses). What changes from call to call reaches the
graph through memory it holds:

  * the inputs are copied into static buffers;
  * the temperature and the noise scale lie in 0-dim float32 tensors that
    the call writes, and the sampler kernels read from device memory: a
    Python number would be baked into the graph as the captured call's;
  * the noise comes from a persistent generator registered with the graph
    and seeded before each call (``batch_seed(seed, i)`` at the caller); a
    replay reads its seed and offset when it starts, and so draws what a
    fresh generator with that seed draws.

Protocol: a key's first call runs eagerly on a side stream and returns its
own result. It builds what a capture cannot: the kernels' libraries
(``ops/_build.load`` may run ``nvcc``), cuBLAS's and cuDNN's plans. The
second call captures, then replays; every later call is a replay. A
replay's result is the graph's static output, which the next call with
that key overwrites, so a caller copies it (``.cpu()``, ``.clone()``)
before it calls again. The graph reads the parameters where they lie, so
an in-place update (Adam between the trainer's probes) is seen at the next
replay; a module that is gone takes its graphs with it at the next call.

Each graph holds a private memory pool, freed with the graph
(``EncodeGraph.drop``; the owners' ``drop_graphs``). A capture that fails
raises ``EncodeCaptureError`` naming its first cause: the encode does not
run eagerly in the graph's place. Which route an owner takes follows from
its device and mesh (``ops/cuda_graph.graph_route``); the CPU and a
"model" mesh axis run eagerly.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Optional, Sequence

import torch

from svtpu_torch.ops import cuda_graph
from svtpu_torch.utils.profiling import span

# body(inputs, temperature, noise_scale, generator) -> the encode's tensor
Body = Callable[..., torch.Tensor]


class EncodeCaptureError(RuntimeError):
    """An encode could not be captured as a CUDA graph."""


class _Key:
    """One key's graph: its static inputs, scalars and generator, and what
    it has run."""

    def __init__(self, tag: str, module: torch.nn.Module, inputs,
                 scalars: bool, noisy: bool, device):
        self.tag = tag
        self.module = weakref.ref(module)
        self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                            for t in inputs)
        self.temperature = self.noise_scale = None
        if scalars:
            self.temperature = torch.zeros((), dtype=torch.float32,
                                           device=device)
            self.noise_scale = torch.zeros((), dtype=torch.float32,
                                           device=device)
        self.generator = torch.Generator(device=device) if noisy else None
        self.graph = self.out = self.delta = None
        self.eager = self.replays = 0
        self.capture_s = self.pool_bytes = None

    def load(self, inputs, temperature, noise_scale, seed) -> None:
        for buf, t in zip(self.inputs, inputs):
            if t.device.type == "cuda":
                buf.copy_(t, non_blocking=True)
            else:
                # From the host the copy is synchronous: the host waits.
                with span("svtpu.graph.copy_in.wait"):
                    buf.copy_(t)
        if self.temperature is not None:
            self.temperature.fill_(float(temperature))
            self.noise_scale.fill_(float(noise_scale))
        if self.generator is not None:
            self.generator.manual_seed(seed)

    def run(self, body: Body) -> torch.Tensor:
        return body(self.inputs, self.temperature, self.noise_scale,
                    self.generator)


class EncodeGraph:
    """An owner's encodes as CUDA graphs, one a key (see the module's
    docstring). ``captures`` and ``replays`` count, over the process, the
    graphs captured and the calls replayed; ``report()`` gives each key's."""

    captures = 0
    replays = 0

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise EncodeCaptureError(
                f"a CUDA graph of an encode needs a CUDA device, not "
                f"{self.device}; on the CPU the encode runs eagerly")
        self.launches = cuda_graph.Launches()
        self._keys: dict = {}

    def __call__(self, tag: str, module: torch.nn.Module, static: tuple,
                 body: Body, inputs: Sequence[torch.Tensor],
                 temperature=None, noise_scale=None,
                 seed: Optional[int] = None) -> torch.Tensor:
        """Run ``body(inputs, temperature, noise_scale, generator)`` for
        this call: eagerly at a key's first call, else as the key's graph.

        ``inputs``: tensors on the host or the card, copied into the key's
        static buffers. ``temperature`` and ``noise_scale``: numbers, which
        reach ``body`` as 0-dim float32 tensors on the card, or both None.
        ``seed``: the noise's seed, or None for an encode without noise
        (``body`` then gets no generator). ``static``: what else the graph
        depends on and the caller knows (``hard``, ``noise``).
        """
        key = (tag, static, temperature is None, seed is None,
               tuple((tuple(t.shape), t.dtype) for t in inputs),
               tuple(p.data_ptr() for p in module.parameters()))
        with torch.inference_mode():
            k = self._keys.get(key)
            if k is not None and k.module() is not module:
                k = None                    # the module it read is gone
            if k is None:
                self._forget_the_dead()
                k = self._keys[key] = _Key(tag, module, inputs,
                                           temperature is not None,
                                           seed is not None, self.device)
            k.load(inputs, temperature, noise_scale, seed)
            if k.graph is None and not k.eager:
                k.eager += 1
                return cuda_graph.on_side_stream(lambda: k.run(body),
                                                 self.device)
            if k.graph is None:
                self._capture(k, body)
                k.load(inputs, temperature, noise_scale, seed)
            k.graph.replay()
            self.launches.add(k.delta)
            k.replays += 1
            EncodeGraph.replays += 1
            return k.out

    def _forget_the_dead(self) -> None:
        """Free the graphs of modules that are gone (or stand at another
        module's address)."""
        for key, k in list(self._keys.items()):
            m = k.module()
            if m is None or key[-1] != tuple(p.data_ptr()
                                             for p in m.parameters()):
                if k.graph is not None:
                    k.graph.reset()
                del self._keys[key]

    def _capture(self, k: _Key, body: Body) -> None:
        t0 = time.perf_counter()
        k.graph, k.out, k.delta = cuda_graph.capture(
            lambda: k.run(body),
            [] if k.generator is None else [k.generator], self.device,
            EncodeCaptureError, f"the encode {k.tag!r}",
            "the encode does not run eagerly in its place", self.launches)
        k.capture_s = time.perf_counter() - t0
        k.pool_bytes = cuda_graph.pool_bytes(k.graph)
        EncodeGraph.captures += 1

    def report(self) -> list:
        """Each key's tag, input shapes, static flags, eager calls (its
        first), graphs captured (0 or 1), replays, the capture's host
        seconds, its pool's bytes, and the kernel launches a replay adds,
        by wrapper (None before the capture)."""
        return [{"tag": k.tag, "static": key[1],
                 "inputs": [list(shape) for shape, _ in key[4]],
                 "eager": k.eager, "captures": int(k.graph is not None),
                 "replays": k.replays, "capture_s": k.capture_s,
                 "pool_bytes": k.pool_bytes,
                 "replay_launches": None if k.delta is None else {
                     c.__name__: n for c, (n, _) in zip(
                         self.launches.counters, k.delta)}}
                for key, k in self._keys.items()]

    def drop(self) -> None:
        """Free every graph and its memory pool."""
        for k in self._keys.values():
            if k.graph is not None:
                k.graph.reset()
        self._keys = {}


def run_encode(graphs: Optional[EncodeGraph], device, tag: str,
               module: torch.nn.Module, static: tuple, body: Body,
               inputs: Sequence[torch.Tensor], temperature=None,
               noise_scale=None, seed: Optional[int] = None) -> torch.Tensor:
    """One encode on its route: as ``graphs``' graph (its arguments are
    ``EncodeGraph.__call__``'s), or, with ``graphs`` None, eagerly: the
    inputs moved to ``device``, the noise from a fresh generator seeded
    with ``seed``, the scalars passed as they are."""
    if graphs is not None:
        return graphs(tag, module, static, body, inputs, temperature,
                      noise_scale, seed)
    generator = None
    if seed is not None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return body(tuple(t.to(device) for t in inputs), temperature,
                noise_scale, generator)


class GraphedEncodes:
    """An owner of encodes whose route follows ``_graphed`` (set from
    ``cuda_graph.graph_route`` at construction; a check may set it to False
    after, as the eager reference on the card). Its ``EncodeGraph`` is made
    at the first graphed call, so that an owner forced onto the graph route
    off the card raises ``EncodeCaptureError`` there."""

    _graphed = False
    _encode_graphs: Optional[EncodeGraph] = None

    def encode_graphs(self) -> Optional[EncodeGraph]:
        """The owner's ``EncodeGraph`` on the graph route, else None."""
        if not self._graphed:
            return None
        if self._encode_graphs is None:
            self._encode_graphs = EncodeGraph(self.device)
        return self._encode_graphs

    def run_encode(self, *args, **kwargs) -> torch.Tensor:
        """``run_encode`` on the owner's route and device."""
        return run_encode(self.encode_graphs(), self.device, *args, **kwargs)

    def drop_graphs(self) -> None:
        """Free the owner's graphs and their memory pools."""
        if self._encode_graphs is not None:
            self._encode_graphs.drop()
            self._encode_graphs = None
