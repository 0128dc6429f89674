"""The frozen operation counts against the figures measured with the
port's smoke script (PERF.md): 183.6 GFLOP for fused_conv01 at B = 512,
3.248 TFLOP for flash_attention at [8, 14080, 512], 1.260 TFLOP a flagship
train step."""
import json
from pathlib import Path

import pytest

from portbench import counts

CONF = json.loads((Path(__file__).resolve().parents[1] / "configs"
                   / "rbvae-flagship.json").read_text())["model"]
SD = {"ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
      "in_channels": 3, "z_channels": 4, "embed_dim": 4}


def test_fused_conv01():
    ops, nbytes = counts.fused_conv01(CONF, 512)
    assert ops / 1e9 == pytest.approx(183.6, abs=0.05)
    # bf16 frames in, bf16 [64, 64, 64] out, float32 weights.
    assert nbytes == 512 * (256 * 256 * 3 + 64 * 64 * 64) * 2 \
        + 4 * (64 * 27 + 64 + 64 * 576 + 64)
    # Compute-bound: 0.1857 ms.
    assert counts.roofline_s(ops, nbytes) * 1e3 == pytest.approx(0.1857,
                                                                 abs=1e-4)


def test_flash_attention():
    ops, nbytes = counts.flash_attention(8, 14080, 512)
    assert ops / 1e12 == pytest.approx(3.248, abs=5e-4)
    assert counts.roofline_s(ops, nbytes) * 1e3 == pytest.approx(3.284,
                                                                 abs=1e-3)


def test_lstm_binary_concrete():
    ops, nbytes = counts.lstm_binary_concrete(CONF, 512)
    assert ops == 2 * 512 * 2 * (4 * 25 * 25 * 2)
    assert nbytes > 0


def test_train_step():
    assert counts.train_step_flops(CONF, 2 * 32 * 5) / 1e12 \
        == pytest.approx(1.260, abs=5e-4)


def test_frame_encodes():
    # trunk 217.06M + fc 1.64M + LSTM 0.01M multiply-adds.
    assert counts.pixel_encode_flops(CONF) == 2 * (217055232 + 1638400
                                                   + 10000)
    # The SD encoder at 704 x 1280: ~4.1 TFLOP, attention 0.41 of it.
    sd = counts.sd_encode_flops(SD, 704, 1280)
    assert sd / 1e12 == pytest.approx(4.126, abs=1e-3)
    attn = 2.0 * 2 * 14080 * 14080 * 512
    assert attn / 1e12 == pytest.approx(0.406, abs=1e-3)
