"""The clip cell (``vjepa2-encode.clip2``): its frozen count against a
hand count, its four readers on a synthetic trace, and its driver at a
tiny size on the CPU, sound and with each fault it can have."""
import copy
import json
import time
from pathlib import Path

import pytest

from portbench import counts, counts_vjepa2
from portbench.run import run_cell

from test_portbench_tracing import ev, read, trace

CELL = "vjepa2-encode.clip2"
W, SPAN = "portbench.window", "user_annotation"
CONF = json.loads((Path(__file__).resolve().parents[1] / "configs"
                   / "vjepa2-vitl-fpc64-256.json").read_text())
# hidden 96, 3 heads of 32, 2 layers, clips of 8 frames at 32 x 32, patch
# 8: 4 x 4 x 4 = 64 tokens; the RBVAE on 4 x 4 grids of 96 channels;
# float32, so that a sound run reads far under the limits below.
TINY_VIT = {"crop_size": 32, "frames_per_clip": 8, "patch_size": 8,
            "hidden_size": 96, "num_attention_heads": 3,
            "num_hidden_layers": 2, "compute_dtype": "float32"}
TINY = {"config": {"vjepa2": TINY_VIT,
                   "model": {"in_channels": 96, "out_channels": 96,
                             "input_hw": [4, 4], "conv_features": [16, 16, 16],
                             "compute_dtype": "float32"}},
        "traffic": {"batch": 13, "frame_hw": [40, 72], "batches": 3,
                    "greedy_every": 2, "check_greedy": 3, "check_noisy": 3},
        # A sound float32 run reads ~1e-6: limits for this size, far under
        # the RoPE fault's ~8e-3.
        "limits": {"feature_err": 1e-4, "code_gap": 1e-4}}
SEED = 2 ** 31 + 12345


def test_clip_count_by_hand():
    """The tiny encoder: embed 64 tokens x 384 x 96; per layer q, k, v, o
    4 x 64 x 96^2, the MLP 2 x 64 x 96 x 384, attention 2 x 64^2 x 96."""
    cfg = dict(CONF["vjepa2"], **TINY_VIT)
    assert counts_vjepa2.tokens(cfg) == 64
    macs = 64 * 384 * 96 + 2 * (4 * 64 * 96 * 96 + 2 * 64 * 96 * 384
                                + 2 * 64 * 64 * 96)
    assert counts_vjepa2.clip_flops(cfg) == 2 * macs
    # The cell's size: 11.57 TFLOP a clip, attention 6.60 of it.
    full = counts_vjepa2.clip_macs(CONF["vjepa2"])
    assert counts_vjepa2.clip_flops(CONF["vjepa2"]) / 1e12 \
        == pytest.approx(11.571, abs=1e-3)
    assert 2 * full["attention"] / 1e12 == pytest.approx(6.597, abs=1e-3)


def _cell():
    return json.loads((Path(__file__).resolve().parents[1] / "workloads"
                       / f"{CELL}.json").read_text())


def test_readers_on_a_synthetic_trace(tmp_path):
    """A window of 2 ms and two requests: busy 1.5 ms, of which the
    attention kernel 0.9 ms (two launches, one overlapping a copy); the
    clip encoder's span 300 and 100 us."""
    s = trace(tmp_path, [
        ev(W, SPAN, 0, 2000),
        ev("svtpu.pipeline.run_frames", SPAN, 0, 1000),
        ev("svtpu.clip.encode", SPAN, 10, 300),
        ev("svtpu.pipeline.run_frames", SPAN, 1000, 1000),
        ev("svtpu.clip.encode", SPAN, 1010, 100),
        ev("void flash_bf16_kernel(unsigned short const*)", "kernel", 100,
           500),
        ev("void flash_bf16_kernel(unsigned short const*)", "kernel", 1100,
           400),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1400, 300),
        ev("ampere_bf16_gemm", "kernel", 1700, 300),
    ])
    cell = _cell()
    conf = {"vjepa2": CONF["vjepa2"]}
    # [100, 600) + [1100, 1700) + [1700, 2000): 1.4 ms busy.
    assert read("attention_pct.vjepa2", s) == pytest.approx(100 * 0.9 / 1.4)
    assert read("encode_ms.vjepa2", s) == pytest.approx(0.2)
    flops = counts_vjepa2.clip_flops(CONF["vjepa2"])
    assert read("mfu_pct.vjepa2", s, config=conf, work={"clips": 4}) \
        == pytest.approx(100 * 4 * flops / 2e-3 / counts.PEAK_BF16_FLOPS)
    least = counts.roofline_s(*counts.flash_attention(32, 8192, 64))
    assert read("roofline_pct.flash_d64", s, config=conf, cell=cell) \
        == pytest.approx(100 * 2 * least / 0.9e-3)


def test_readers_find_nothing_in_a_parent_trace(tmp_path):
    """A program without the clip path: no attention kernel at D = 64, no
    clip span, no clips: every reader returns None."""
    s = trace(tmp_path, [
        ev(W, SPAN, 0, 2000),
        ev("svtpu.pipeline.run_frames", SPAN, 0, 1000),
        ev("void flash_d512_kernel(CUtensorMap)", "kernel", 100, 500),
    ])
    conf = {"vjepa2": CONF["vjepa2"]}
    assert read("attention_pct.vjepa2", s) is None
    assert read("encode_ms.vjepa2", s) is None
    assert read("mfu_pct.vjepa2", s, config=conf) is None
    assert read("roofline_pct.flash_d64", s, config=conf, cell=_cell()) \
        is None


def run(trace_=False, sizes=TINY, **kw):
    return run_cell(CELL, SEED, 0.5, trace_, time.perf_counter(),
                    device="cpu", sizes=copy.deepcopy(sizes), **kw)


def test_sound_run_is_correct_and_traced_run_reads_its_metrics():
    r = run()
    assert r["correct"] and r["attempted"] > 0
    assert r["checks"]["feature_err"]["value"] < 1e-5
    t = run(trace_=True)
    got = {k: v["value"] for k, v in t["metrics"].items()}
    assert t["correct"]
    assert {"mfu_pct.vjepa2", "encode_ms.vjepa2"} <= set(got)
    assert got["encode_ms.vjepa2"] > 0


@pytest.mark.parametrize("fault, fails", [
    ("rope_off", "feature_err"),
    ("noise_off", "flip_z"),
    ("noise_x2", "flip_z"),
])
def test_faults_fail(fault, fails):
    """The rotary embedding left out fails ``feature_err``; the noisy
    pipeline without noise, or with its scale doubled, fails ``flip_z``."""
    r = run(fault=fault)
    assert not r["correct"]
    c = r["checks"][fails]
    assert c["value"] > c["limit"]


def test_features_altered_where_produced(monkeypatch):
    """The clip encoder's features scaled by 1.01 before the RBVAE reads
    them: ``feature_err`` fails."""
    from svtpu_torch.perceptual.clip import ClipEncoder

    encode = ClipEncoder.encode_frames
    monkeypatch.setattr(ClipEncoder, "encode_frames",
                        lambda self, f: encode(self, f) * 1.01)
    r = run()
    assert not r["correct"]
    assert r["checks"]["feature_err"]["value"] > 1e-3
