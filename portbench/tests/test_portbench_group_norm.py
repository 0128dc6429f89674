"""The SD encoder's norms: the frozen count of their elements against the
program's own norms seen through hooks at a small configuration, the
count at the cell's size, and ``roofline_pct.group_norm_silu``'s reader on
a synthetic trace and on a parent's."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, counts_group_norm

from test_portbench_tracing import ev, read, trace

BENCH = Path(__file__).resolve().parents[1]
CONF = json.loads((BENCH / "configs" / "sd-v1-percep.json").read_text())
CELL = json.loads((BENCH / "workloads" / "percep-encode.sd8.json")
                  .read_text())
SMALL = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2, 4),
             num_res_blocks=2, in_channels=3, out_ch=3,
             compute_dtype="float32")
W, SPAN = "portbench.window", "user_annotation"
LABEL = "void (anonymous namespace)::%s<__nv_bfloat16, 4, true>(const " \
        "__nv_bfloat16*, float2*, int, int, int)"


@pytest.mark.parametrize("hw", [(32, 48), (42, 30)])
def test_count_equals_the_hooked_norms(hw):
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.models.autoencoder_kl import (AutoencoderKL,
                                                   GroupNormSiLU)

    model = AutoencoderKL(PerceptualConfig(**SMALL), device="cpu")
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].shape[1],
                                       args[0][0].numel())))
        for m in model.encoder.modules() if isinstance(m, GroupNormSiLU)]
    x = torch.from_numpy(np.zeros((2,) + hw + (3,), np.float32))
    with torch.inference_mode():
        model.encode(x)
    for h in handles:
        h.remove()
    sd = dict(SMALL, ch_mult=list(SMALL["ch_mult"]))
    want = counts_group_norm.instances(sd, *hw)
    assert [(c, c * px) for c, px in want] == seen
    assert counts_group_norm.elements(sd, *hw) == sum(n for _, n in seen)


def test_count_at_the_cell_size():
    """22 norms, 836.2 M elements a 704x1280 frame; a batch of 8 in bf16
    moves 26.76 GB at least, 7.988 ms at 3.35 TB/s."""
    sd, (h, w) = CONF["sd"], CELL["traffic"]["sd_hw"]
    assert len(counts_group_norm.instances(sd, h, w)) == 22
    assert counts_group_norm.elements(sd, h, w) == 836_239_360
    least = counts_group_norm.least_s(sd, h, w, 8)
    assert least == pytest.approx(4 * 8 * 836_239_360
                                  / counts.PEAK_HBM_BYTES_S)
    assert least * 1e3 == pytest.approx(7.988, abs=1e-3)


def test_reader_on_a_synthetic_trace(tmp_path):
    """Two batches' 44 norms, each three launches: statistics 10 us, merge
    2 us, apply 12 us, beside a conv."""
    events = [ev(W, SPAN, 0, 2000),
              ev("sm90_xmma_fprop_implicit_gemm", "kernel", 1100, 400)]
    for i in range(44):
        t0 = 20 * i
        events += [ev(LABEL % "group_norm_silu_stats_kernel", "kernel",
                      t0, 10),
                   ev(LABEL % "group_norm_silu_merge_kernel", "kernel",
                      t0 + 10, 2),
                   ev(LABEL % "group_norm_silu_kernel", "kernel", t0 + 12,
                      12)]
    s = trace(tmp_path, events)
    sd, (h, w) = CONF["sd"], CELL["traffic"]["sd_hw"]
    least = counts_group_norm.least_s(sd, h, w, CELL["traffic"]["batch"])
    got = read("roofline_pct.group_norm_silu", s, config=CONF, cell=CELL)
    assert got == pytest.approx(100 * 2 * least / (44 * 24e-6))


def test_reader_finds_nothing_in_a_parent_trace(tmp_path):
    """The parent's norms are PyTorch's passes: no kernel of this name."""
    s = trace(tmp_path, [
        ev(W, SPAN, 0, 2000),
        ev("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel"
           "<float>(long, float, float const*, float*, float*)", "kernel",
           100, 500),
        ev("void flash_d512_kernel(CUtensorMap)", "kernel", 700, 500)])
    assert read("roofline_pct.group_norm_silu", s, config=CONF,
                cell=CELL) is None
