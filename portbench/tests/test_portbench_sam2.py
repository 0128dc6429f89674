"""The SAM 2 cell (``sam2-encode.hd32``): its frozen counts against the
published widths and a hand count, its five readers on a synthetic trace
and on a parent's, and its driver at a small size on the CPU, sound and
with each fault it can have."""
import copy
import dataclasses
import json
import time
from collections import Counter
from pathlib import Path

import pytest

from portbench import counts, counts_sam2
from portbench.run import run_cell

from test_portbench_tracing import ev, read, trace

CELL = "sam2-encode.hd32"
W, SPAN = "portbench.window", "user_annotation"
CONF = json.loads((Path(__file__).resolve().parents[1] / "configs"
                   / "sam2.1-hiera-large.json").read_text())
# A 128x128 image (a 32x32 grid), widths 72-144-288-576, blocks 1-2-3-1,
# windows 8-4-4-2, block 5 global; the RBVAE on 8x8 grids of 256 channels;
# float32, so that a sound run reads far under the limits below.
SMALL_SAM2 = {"image_size": 128, "embed_dim_per_stage": [72, 144, 288, 576],
              "num_attention_heads_per_stage": [1, 2, 4, 8],
              "blocks_per_stage": [1, 2, 3, 1],
              "window_size_per_stage": [8, 4, 4, 2],
              "global_attention_blocks": [5],
              "backbone_channel_list": [576, 288, 144, 72],
              "compute_dtype": "float32"}
SMALL = {"config": {"sam2": SMALL_SAM2,
                    "model": {"input_hw": [8, 8], "conv_features": [16, 16, 16],
                              "compute_dtype": "float32"}},
         # 4 noisy requests of 8 frames checked: 800 bits, so that the
         # doubled noise stands out of flip_z's spread.
         "traffic": {"batch": 8, "frame_hw": [40, 72], "batches": 4,
                     "greedy_every": 2, "check_greedy": 2, "check_noisy": 4},
         # A sound float32 run reads ~1e-6: limits for this size, far under
         # the global_windowed fault's reading.
         "limits": {"feature_err": 1e-4, "code_gap": 1e-4}}
SEED = 2 ** 31 + 54321


def test_frame_count_and_shapes_at_the_published_widths():
    """1.814 TFLOP a frame: GEMMs 1.606, attention 0.203, patch embed
    0.003, the neck's two convs 0.002 (with the 256² and 128² laterals,
    which the encode does not run, 1.821); the eight attention shapes of a
    frame, each with its blocks."""
    cfg = CONF["sam2"]
    macs = counts_sam2.frame_macs(cfg)
    assert counts_sam2.frame_flops(cfg) / 1e12 == pytest.approx(1.8140,
                                                                abs=1e-4)
    assert 2 * macs["gemms"] / 1e12 == pytest.approx(1.6063, abs=1e-4)
    assert 2 * macs["attention"] / 1e12 == pytest.approx(0.2031, abs=1e-4)
    laterals = 2 * (128 * 128 * 288 + 256 * 256 * 144) * 256
    assert (counts_sam2.frame_flops(cfg) + laterals) / 1e12 \
        == pytest.approx(1.821, abs=1e-3)
    got = Counter(counts_sam2.attention_shapes(cfg))
    assert got == {(2048, 64, 64, 72, False): 2, (4096, 16, 64, 72, False): 1,
                   (4096, 16, 16, 72, False): 5, (8192, 4, 16, 72, False): 1,
                   (128, 256, 256, 72, False): 32,
                   (8, 4096, 4096, 72, True): 3,
                   (256, 64, 256, 72, False): 1, (256, 64, 64, 72, False): 3}
    ops, nbytes = counts_sam2.attention(8, 4096, 4096, 72)
    assert ops == 4.0 * 8 * 4096 ** 2 * 72 and nbytes == 2 * 8 * 72 * 4 * 4096


def test_frame_count_by_hand():
    """The small encoder: the patch embed 32^2 x 147 x 72; block 0 on 1,024
    tokens of 72; block 1 pools 1,024 tokens of 72 to 256 of 144; the
    global block 5 one window of 64 tokens."""
    cfg = dict(CONF["sam2"], **SMALL_SAM2)
    macs = counts_sam2.frame_macs(cfg)
    assert macs["embed"] == 32 * 32 * 147 * 72
    b0 = 1024 * 72 * 216 + 1024 * 72 * 72 + 2 * 1024 * 72 * 288
    b1 = (1024 * 72 * 432 + 256 * 144 * 144 + 2 * 256 * 144 * 576
          + 1024 * 72 * 144)
    blocks = counts_sam2.blocks(cfg)
    assert blocks[0] == (32, 72, 72, 1, 8, False)
    assert blocks[1] == (32, 72, 144, 2, 8, True)
    assert blocks[5] == (8, 288, 288, 4, 0, False)
    shapes = counts_sam2.attention_shapes(cfg)
    assert shapes[0] == (16, 64, 64, 72, False)
    assert shapes[1] == (32, 16, 64, 72, False)
    assert shapes[5] == (4, 64, 64, 72, True)
    assert macs["gemms"] > b0 + b1


def _cell():
    return json.loads((Path(__file__).resolve().parents[1] / "workloads"
                       / f"{CELL}.json").read_text())


def test_readers_on_a_synthetic_trace(tmp_path):
    """A window of 2 ms and two requests: the windowed kernel's 90
    launches (45 a request) and the global kernel's 6 (3 a request)
    beside a copy and a GEMM; the encoder's span 300 and 100 us."""
    events = [ev(W, SPAN, 0, 2000),
              ev("svtpu.pipeline.run_frames", SPAN, 0, 1000),
              ev("svtpu.sam2.encode", SPAN, 10, 300),
              ev("svtpu.pipeline.run_frames", SPAN, 1000, 1000),
              ev("svtpu.sam2.encode", SPAN, 1010, 100),
              ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1400, 300),
              ev("sm90_bf16_gemm", "kernel", 1700, 300)]
    label = "void (anonymous namespace)::%s((anonymous namespace)::Params)"
    for i in range(90):     # 45 a request, 10 us each, in [100, 1000)
        t0 = 100 + 10 * i if i < 45 else 1100 + 10 * (i - 45)
        events.append(ev(label % "window_attn_kernel", "kernel", t0, 10 if
                         i % 3 else 5))
    for i in range(6):
        events.append(ev(label % "flash_d72_kernel", "kernel", 600 + 50 * i,
                         50))
    s = trace(tmp_path, events)
    cell = _cell()
    conf = {"sam2": CONF["sam2"]}
    n_win, win_s = s.launches("window_attn_kernel")
    assert n_win == 90
    busy = s.busy_s
    covered = s.share(lambda lab, cat, full: cat == "kernel" and lab in (
        "window_attn_kernel", "flash_d72_kernel")) * s.window_s
    assert read("attention_pct.sam2", s) == pytest.approx(
        100 * covered / busy)
    assert read("encode_ms.sam2", s) == pytest.approx(0.2)
    flops = counts_sam2.frame_flops(CONF["sam2"])
    assert read("mfu_pct.sam2", s, config=conf, work={"frames": 64}) \
        == pytest.approx(100 * 64 * flops / 2e-3 / counts.PEAK_BF16_FLOPS)
    least_w = counts_sam2.attention_least_s(CONF["sam2"], 32, False)
    assert read("roofline_pct.window_attn", s, config=conf, cell=cell) \
        == pytest.approx(100 * 2 * least_w / win_s)
    least_g = counts_sam2.attention_least_s(CONF["sam2"], 32, True)
    assert read("roofline_pct.flash_d72", s, config=conf, cell=cell) \
        == pytest.approx(100 * 2 * least_g / 300e-6)


def test_readers_find_nothing_in_a_parent_trace(tmp_path):
    """A program without the image encoder: no D = 72 kernel, no SAM 2
    span, no frames of it: every reader returns None."""
    s = trace(tmp_path, [
        ev(W, SPAN, 0, 2000),
        ev("svtpu.pipeline.run_frames", SPAN, 0, 1000),
        ev("void flash_d512_kernel(CUtensorMap)", "kernel", 100, 500),
    ])
    conf = {"sam2": CONF["sam2"]}
    assert read("attention_pct.sam2", s) is None
    assert read("encode_ms.sam2", s) is None
    assert read("mfu_pct.sam2", s, config=conf) is None
    for name in ("roofline_pct.window_attn", "roofline_pct.flash_d72"):
        assert read(name, s, config=conf, cell=_cell()) is None


def run(trace_=False, sizes=SMALL, **kw):
    return run_cell(CELL, SEED, 1.0, trace_, time.perf_counter(),
                    device="cpu", sizes=copy.deepcopy(sizes), **kw)


def test_sound_run_is_correct_and_traced_run_reads_its_metrics():
    r = run()
    assert r["correct"] and r["attempted"] > 0
    assert r["checks"]["feature_err"]["value"] < 1e-5
    t = run(trace_=True)
    got = {k: v["value"] for k, v in t["metrics"].items()}
    assert t["correct"]
    assert {"mfu_pct.sam2", "encode_ms.sam2"} <= set(got)
    assert got["encode_ms.sam2"] > 0


@pytest.mark.parametrize("fault, fails", [
    ("global_windowed", "feature_err"),
    ("noise_off", "flip_z"),
    ("noise_x2", "flip_z"),
])
def test_faults_fail(fault, fails):
    """The global block run in windows fails ``feature_err``; the noisy
    pipeline without noise, or with its scale doubled, fails ``flip_z``
    (a number the window's requests could not give reads NaN, and fails
    too)."""
    r = run(fault=fault)
    assert not r["correct"]
    c = r["checks"][fails]
    assert not c["value"] <= c["limit"]


def test_the_small_config_is_a_program_config():
    """The sizes above make a configuration the program takes."""
    from portbench.drivers.frame_encode import sam2_config

    cfg = sam2_config({"sam2": dict(CONF["sam2"], **SMALL_SAM2)})
    assert dataclasses.asdict(cfg)["image_size"] == 128
    assert cfg.feature_hw == 8
