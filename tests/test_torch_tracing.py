"""The port's spans (``utils.profiling.span``) on the CPU: free with no
profiler running, and under one, where each layer boundary puts them in
the Chrome trace that ``torch.profiler`` exports: the request's and the
epoch's spans nested under their outermost span, inside a
``record_function`` window opened around the call, on the trace's clock."""
import contextlib
import json

import numpy as np
import pytest
import torch

from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.models.encode_graph import EncodeGraph
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import cuda_graph
from svtpu_torch.pipeline import VideoSymbolPipeline
from svtpu_torch.training.trainer import Trainer
from svtpu_torch.utils.profiling import span

from _torch_port import ArrayStore

WINDOW = "test.window"
CFG = rbvae_variant("contrastive", 6, input_hw=(32, 32),
                    conv_features=(8, 8, 8))


def traced(fn, tmp_path) -> list:
    """``fn()`` under a CPU profiler, inside a ``record_function`` window;
    returns the program's spans of the exported Chrome trace as ``(name,
    start, end)`` in order of start, each checked to lie inside the
    window on the one thread."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (window,) = [e for e in events if e["name"] == WINDOW]
    lo, hi = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    spans = sorted((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]), e["tid"])
                   for e in events if e["name"].startswith("svtpu."))
    assert spans
    for name, s, t, tid in spans:
        assert lo <= s <= t <= hi and tid == window["tid"], name
    return sorted(((n, s, t) for n, s, t, _ in spans), key=lambda x: x[1])


def within(spans, outer, name: str) -> list:
    """The spans named ``name`` that lie inside the span ``outer``."""
    return [x for x in spans if x[0] == name
            and outer[1] <= x[1] and x[2] <= outer[2] and x != outer]


def test_a_span_with_no_profiler_enters_no_record_function(monkeypatch):
    """With no profiler running a span is one check of the profiler's state
    and the same shared no-op context each call; under a profiler the same
    call enters a ``record_function``."""

    def entered(*args, **kwargs):
        raise AssertionError("record_function entered")

    checks = []
    enabled = torch._C._autograd._profiler_enabled
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        entered)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled",
                        lambda: checks.append(1) or enabled())
    first = span("svtpu.test.a")
    assert span("svtpu.test.b") is first and len(checks) == 2
    with first, span("svtpu.test.c"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            with span("svtpu.test.d"):
                pass


@pytest.mark.parametrize("resize_on", ["device", "host"])
def test_run_frames_spans(resize_on, tmp_path):
    """A pixel request: ``run_frames`` holds the encode and the readback,
    and the host resize where the frames are resized on the host."""
    params = Seq2SeqBinaryVAE(CFG, device="cpu").state_dict()
    pipe = VideoSymbolPipeline(CFG, params, resize_on=resize_on,
                               device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (4, 45, 70, 3),
                                               np.uint8)
    spans = traced(lambda: pipe.run_frames(frames, batch_index=3), tmp_path)
    (request,) = [x for x in spans if x[0] == "svtpu.pipeline.run_frames"]
    inner = {"svtpu.pipeline.encode", "svtpu.pipeline.readback.wait"}
    if resize_on == "host":
        inner.add("svtpu.pipeline.resize_host")
    assert {x[0] for x in spans} == inner | {request[0]}
    for name in inner:
        assert len(within(spans, request, name)) == 1, name
    encode, = within(spans, request, "svtpu.pipeline.encode")
    readback, = within(spans, request, "svtpu.pipeline.readback.wait")
    assert encode[2] <= readback[1]


def test_train_epoch_spans(tmp_path):
    """Two fused epochs of ``Trainer.train``: each epoch holds its data,
    steps and readback, then its epoch end, which holds the val step and
    the two probes."""
    frames = np.random.default_rng(0).integers(0, 256, (60, 32, 32, 3),
                                               np.uint8)
    splits = split_segments(((0, 20), (20, 40), (40, 60)), 0.2, 0.2)
    tr = Trainer(CFG, TrainConfig(batch_size=4, num_epochs=2,
                                  num_steps_to_update=2),
                 ArrayStore(frames), splits, (20, 40), device="cpu")
    spans = traced(lambda: tr.train(num_epochs=2), tmp_path)
    epochs = [x for x in spans if x[0] == "svtpu.train.epoch"]
    assert len(epochs) == 2
    for epoch in epochs:
        (end,) = within(spans, epoch, "svtpu.train.epoch_end")
        assert len(within(spans, end, "svtpu.train.val")) == 1
        assert len(within(spans, end, "svtpu.train.probe")) == 2
        for name in ("svtpu.train.data", "svtpu.train.steps",
                     "svtpu.train.readback.wait"):
            (x,) = within(spans, epoch, name)
            assert x[2] <= end[1], name


@pytest.fixture
def fake_capture(monkeypatch):
    """``torch.cuda``'s graph capture stubbed out: the body runs on the
    CPU as a capture would record it."""

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cuda_graph, "on_side_stream", lambda fn, d: fn())
    monkeypatch.setattr(cuda_graph, "pool_bytes", lambda graph: 0)


def test_a_capture_span_a_capture(fake_capture, tmp_path):
    """``svtpu.graph.capture`` fires once a capture, whether it succeeds or
    fails; through ``EncodeGraph``'s protocol (eager, capture, replays),
    once for the key, and every load of a host input waits in
    ``svtpu.graph.copy_in.wait``."""
    launches = cuda_graph.Launches([])

    def fail():
        raise KeyError("the body's own error")

    def captures():
        cuda_graph.capture(lambda: torch.zeros(()), [], "cpu",
                           RuntimeError, "a stub", "", launches)
        with pytest.raises(RuntimeError):
            cuda_graph.capture(fail, [], "cpu", RuntimeError, "a stub", "",
                               launches)

    spans = traced(captures, tmp_path)
    assert [x[0] for x in spans] == ["svtpu.graph.capture"] * 2

    graphs = EncodeGraph.__new__(EncodeGraph)   # the CPU stands for a card
    vars(graphs).update(device=torch.device("cpu"), launches=launches,
                        _keys={})
    module = torch.nn.Linear(1, 1)

    def body(inputs, temperature, noise_scale, gen):
        return inputs[0] * temperature

    def calls():
        for _ in range(4):
            graphs("enc", module, (), body, (torch.arange(3.0),), 2.0, 0.1)

    names = [x[0] for x in traced(calls, tmp_path)]
    assert names.count("svtpu.graph.capture") == 1
    # One load a call, and the capture's call loads again after it.
    assert names.count("svtpu.graph.copy_in.wait") == 5
