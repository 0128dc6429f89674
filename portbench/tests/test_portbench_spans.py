"""The readers of the program's spans (``portbench/spans.py``) on synthetic
traces: clipped to the window, per step and per request, the waits left
out of a request's host time, 0 captures where spans exist, and nothing to
read where the program recorded no span. And a traced run of each
one-card cell at a tiny size on the CPU, read by them."""
import copy
import time

import pytest

from portbench import tracing
from portbench.run import run_cell

from test_portbench_faults import SEED, TINY_ENCODE, TINY_PERCEP, TINY_TRAIN
from test_portbench_tracing import ev, read, trace

W = tracing.WINDOW_SPAN
SPAN = "user_annotation"


def train_trace(tmp_path):
    """A window [1000, 2000) over two epoch boundaries, the first begun
    before it; a capture before the window and one inside it."""
    return trace(tmp_path, [
        ev(W, SPAN, 1000, 1000),
        ev("svtpu.graph.capture", SPAN, 900, 200),           # starts before
        ev("svtpu.train.epoch_end", SPAN, 800, 400),          # 200 inside
        ev("svtpu.train.val", SPAN, 1100, 50),
        ev("svtpu.train.epoch", SPAN, 1300, 700),
        ev("svtpu.train.steps", SPAN, 1300, 100),
        ev("svtpu.train.epoch_end", SPAN, 1600, 600),         # 400 inside
        ev("svtpu.train.val", SPAN, 1600, 100),
        ev("svtpu.train.probe", SPAN, 1700, 80),
        ev("svtpu.train.probe", SPAN, 1800, 120),
        ev("svtpu.graph.capture", SPAN, 1850, 20),
        ev("svtpu.train.probe", SPAN, 2100, 50),              # after it
        ev("aten::copy_", "cpu_op", 1650, 10),
        ev("k", "kernel", 1300, 250),
    ])


def test_train_spans_clipped_to_the_window_over_steps(tmp_path):
    s = train_trace(tmp_path)
    work = {"steps": 4}
    # (200 + 400) us over 4 steps; val (50 + 100); probes (80 + 120).
    assert read("epoch_end_ms.train", s, work=work) == pytest.approx(0.15)
    assert read("val_ms.train", s, work=work) == pytest.approx(0.0375)
    assert read("probe_ms.train", s, work=work) == pytest.approx(0.05)
    assert read("epoch_end_ms.train", s, work={"steps": 2}) \
        == pytest.approx(0.3)
    # The capture that began before the window is not counted.
    assert read("graph_captures.train", s, work=work) == 1
    assert read("epoch_end_ms.train", s, work={"steps": 0}) is None


def test_encode_host_time_leaves_out_the_waits(tmp_path):
    """Two requests of 400 and 200 us: the first waits in a copy in
    [1050, 1150) and a readback [1300, 1400) that a nested wait overlaps;
    the second in a readback [1700, 1750) and a wait that runs past its
    end."""
    s = trace(tmp_path, [
        ev(W, SPAN, 1000, 1000),
        ev("svtpu.pipeline.run_frames", SPAN, 1000, 400),
        ev("svtpu.pipeline.resize_host", SPAN, 1000, 40),
        ev("svtpu.pipeline.encode", SPAN, 1050, 150),
        ev("svtpu.graph.copy_in.wait", SPAN, 1050, 100),
        ev("svtpu.percep.readback.wait", SPAN, 1300, 100),
        ev("svtpu.pipeline.readback.wait", SPAN, 1350, 30),
        ev("svtpu.pipeline.run_frames", SPAN, 1600, 200),
        ev("svtpu.pipeline.resize_host", SPAN, 1600, 20),
        ev("svtpu.pipeline.readback.wait", SPAN, 1700, 50),
        ev("svtpu.graph.copy_in.wait", SPAN, 1780, 100),      # 20 inside
        ev("portbench.request", SPAN, 1000, 400),
    ])
    # (400 - 200) + (200 - 70) us over 2 requests.
    assert read("host_ms.encode", s) == pytest.approx(0.165)
    assert read("host_resize_ms.encode", s) == pytest.approx(0.03)
    assert read("graph_captures.encode", s) == 0


def test_host_time_clipped_to_the_window(tmp_path):
    """A request that ran past the window's end counts for its part inside
    it, its waits clipped alike."""
    s = trace(tmp_path, [
        ev(W, SPAN, 0, 1000),
        ev("svtpu.pipeline.run_frames", SPAN, 600, 800),
        ev("svtpu.pipeline.readback.wait", SPAN, 900, 300),
    ])
    assert read("host_ms.encode", s) == pytest.approx(0.3)


def test_no_program_span_reads_nothing(tmp_path):
    """The trace of a program that records no span: every reader returns
    None (the metric is left out), captures too; so does a window whose
    spans all lie outside it."""
    s = trace(tmp_path, [
        ev(W, SPAN, 1000, 1000),
        ev("portbench.request", SPAN, 1000, 400),
        ev("aten::copy_", "cpu_op", 1100, 100),
        ev("svtpu.train.epoch_end", SPAN, 2500, 100),
        ev("k", "kernel", 1000, 100),
    ])
    for name in ("epoch_end_ms.train", "val_ms.train", "probe_ms.train",
                 "graph_captures.train"):
        assert read(name, s, work={"steps": 3}) is None, name
    for name in ("host_ms.encode", "host_resize_ms.encode",
                 "graph_captures.encode"):
        assert read(name, s) is None, name


def test_idle_gaps_named_by_a_program_span(tmp_path):
    """A gap where the host ran Python outside any op: without spans it
    reads "no operation", with the program's span over it, the span."""
    events = [ev(W, SPAN, 0, 1000), ev("k", "kernel", 0, 100),
              ev("k", "kernel", 900, 100)]
    assert trace(tmp_path, events).idle_gaps(1)[0][0] \
        == "host: no operation"
    events.append(ev("svtpu.train.epoch_end", SPAN, 50, 900))
    assert trace(tmp_path, events).idle_gaps(1) \
        == [["host: svtpu.train.epoch_end", pytest.approx(800e-6)]]


# The percep frames a size off the SD input, so that the host resizes them.
TRACED_PERCEP = copy.deepcopy(TINY_PERCEP)
TRACED_PERCEP["traffic"]["frame_hw"] = [72, 120]


@pytest.mark.parametrize("cell, sizes, names", [
    ("flagship-train", TINY_TRAIN,
     ("epoch_end_ms.train", "val_ms.train", "probe_ms.train",
      "graph_captures.train")),
    ("pixel-encode.hd64", TINY_ENCODE,
     ("host_ms.encode", "graph_captures.encode")),
    ("percep-encode.sd8", TRACED_PERCEP,
     ("host_ms.encode", "host_resize_ms.encode", "graph_captures.encode")),
])
def test_a_traced_cpu_run_reads_the_program_spans(cell, sizes, names):
    """``--trace 1`` on the CPU: every span metric of the cell is read, a
    part never above its whole, no capture in the window."""
    r = run_cell(cell, SEED, 1.0, True, time.perf_counter(), device="cpu",
                 sizes=sizes)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"] and set(names) <= set(got)
    assert all(got[n] >= 0 for n in names)
    assert got[names[-1]] == 0
    if cell == "flagship-train":
        assert 0 < got["val_ms.train"] + got["probe_ms.train"] \
            <= got["epoch_end_ms.train"]
    if cell == "percep-encode.sd8":
        assert 0 < got["host_resize_ms.encode"] <= got["host_ms.encode"]
