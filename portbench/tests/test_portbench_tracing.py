"""The trace reduction on a synthetic Chrome trace."""
import json
import types

import pytest

from portbench import tracing
from portbench.harness import BENCH_DIR, load_module


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def trace(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return tracing.summarize(p)


def test_busy_union_clip_and_shares(tmp_path):
    s = trace(tmp_path, [
        ev(tracing.WINDOW_SPAN, "user_annotation", 100, 1000),
        ev("void fused_conv01_tc<64>(float*)", "kernel", 50, 100),   # clipped
        ev("void fused_conv01_tc<64>(float*)", "kernel", 300, 100),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 350, 250),
        ev("ampere_gemm", "kernel", 1050, 200),                      # clipped
        ev("aten::copy_", "cpu_op", 650, 300),
        ev("portbench.request", "user_annotation", 600, 400),
    ])
    assert s.window_s == pytest.approx(1e-3)
    # [100, 150) + [300, 600) + [1050, 1100)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.share(lambda lab, cat, full: "HtoD" in full) \
        == pytest.approx(0.25)
    assert s.launches("fused_conv01_tc") == (2, pytest.approx(150e-6))
    assert s.launches("flash_d512_kernel") == (0, 0)
    top = s.top_ops(10)
    assert top[0][0] == "Memcpy HtoD (Pageable -> Device)"
    gaps = s.idle_gaps(2)
    assert gaps[0] == ["host: aten::copy_", pytest.approx(450e-6)]
    assert gaps[1][1] == pytest.approx(150e-6)


def test_no_window_span_is_an_error(tmp_path):
    with pytest.raises(ValueError):
        trace(tmp_path, [ev("k", "kernel", 0, 1)])


def read(name, summary, **kw):
    reader = load_module(BENCH_DIR / "metrics" / f"{name}.py", "m_" + name)
    h = types.SimpleNamespace(trace_summary=summary, work=kw.get("work", {}),
                              cell=kw.get("cell", {}),
                              config=kw.get("config", {}), chips=1)
    return reader.read(h)


def test_readers_on_the_synthetic_trace(tmp_path):
    s = trace(tmp_path, [
        ev(tracing.WINDOW_SPAN, "user_annotation", 0, 1000),
        ev("void fused_conv01_tc<64>(float*)", "kernel", 0, 100),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 500),
    ])
    conf = json.loads((BENCH_DIR / "configs"
                       / "rbvae-flagship.json").read_text())
    assert read("device_idle_pct.encode", s) == pytest.approx(40.0)
    assert read("h2d_pct.encode", s) == pytest.approx(50.0)
    # 64 frames: 22.95 GFLOP, bound 23.21 us, against 100 us.
    r = read("roofline_pct.fused_conv01", s, config=conf,
             cell={"traffic": {"batch": 64}})
    assert r == pytest.approx(100 * 2 * 64 * 179306496 / 989e12 / 100e-6)


def test_a_kernel_missing_from_the_trace_reads_nothing(tmp_path):
    """A reader that finds nothing to read returns None, and the harness
    leaves the metric out; it never reports 0."""
    s = trace(tmp_path, [ev(tracing.WINDOW_SPAN, "user_annotation", 0, 10),
                         ev("other", "kernel", 0, 5)])
    conf = json.loads((BENCH_DIR / "configs"
                       / "rbvae-flagship.json").read_text())
    assert read("roofline_pct.fused_conv01", s, config=conf,
                cell={"traffic": {"batch": 64}}) is None
    assert read("h2d_pct.encode", s) is None
    assert read("step_device_ms.train", s, work={"steps": 0}) is None
