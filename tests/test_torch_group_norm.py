"""``ops/group_norm.py`` on the CPU: the wrapper's plain route against
GroupNorm(32) + SiLU worked out in float64, the layouts it keeps, the
launch counter, its guards, the kernel's tiling; and the SD encoder's norms
seen through hooks: every input and output channels-last, so that the
card's path makes no layout copy around them."""
import numpy as np
import pytest
import torch

from svtpu_torch.config import PerceptualConfig
from svtpu_torch.models.autoencoder_kl import AutoencoderKL, GroupNormSiLU
from svtpu_torch.ops import group_norm as gn

TINY = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1)
THREE_LEVELS = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2, 4),
                    num_res_blocks=2)


def _reference(x, weight, bias, eps, silu):
    """GroupNorm(32) (biased variance) and SiLU in float64 with numpy."""
    a = x.double().numpy()
    B, C, H, W = a.shape
    g = a.reshape(B, 32, C // 32 * H * W)
    mean = g.mean(-1, keepdims=True)
    var = ((g - mean) ** 2).mean(-1, keepdims=True)
    y = ((g - mean) / np.sqrt(var + eps)).reshape(a.shape)
    y = y * weight.double().numpy()[:, None, None] \
        + bias.double().numpy()[:, None, None]
    return y / (1.0 + np.exp(-y)) if silu else y


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("c", [128, 256, 512])
def test_plain_route_matches_group_norm_silu(c, layout, silu):
    g = torch.Generator().manual_seed(c + silu)
    # An offset mean, so that a variance taken as E[x^2] - mean^2 would
    # lose digits.
    x = torch.randn(2, c, 6, 10, generator=g) * 2.0 + 5.0
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g)
    before = gn.group_norm_silu.launches
    got = gn.group_norm_silu(x, w, b, 1e-6, silu, torch.float32)
    assert gn.group_norm_silu.launches == before == 0
    assert got.dtype == torch.float32 and got.shape == x.shape
    fmt = torch.channels_last if layout == "channels_last" \
        else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    np.testing.assert_allclose(got.numpy(), _reference(x, w, b, 1e-6, silu),
                               rtol=1e-5, atol=1e-5)


def test_plain_route_rounds_once_to_the_compute_dtype():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 64, 4, 4, generator=g).bfloat16()
    w, b = torch.ones(64), torch.zeros(64)
    got = gn.group_norm_silu(x, w, b, 1e-6, True, torch.bfloat16)
    f32 = gn.group_norm_silu(x, w, b, 1e-6, True, torch.float32)
    assert got.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(got, f32.bfloat16())
    np.testing.assert_allclose(f32.numpy(), _reference(x.float(), w, b, 1e-6,
                                                       True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["float16", "dtype_change", "width",
                                  "weight_dtype", "grad"])
def test_card_guards(case):
    """What the card's route refuses, checked before any launch."""
    x = torch.zeros(1, 128, 2, 2)
    w, b = torch.ones(128), torch.zeros(128)
    dtype = torch.float32
    if case == "float16":
        x, dtype = x.half(), torch.float16
    elif case == "dtype_change":
        dtype = torch.bfloat16
    elif case == "width":
        x, w, b = torch.zeros(1, 96, 2, 2), torch.ones(96), torch.zeros(96)
    elif case == "weight_dtype":
        w = w.double()
    else:
        w.requires_grad_(True)
    err = TypeError if case in ("float16", "dtype_change") \
        else RuntimeError if case == "grad" else ValueError
    with pytest.raises(err):
        gn._check(x, w, b, dtype)
    with torch.no_grad():
        if case == "grad":
            gn._check(x, w, b, dtype)


@pytest.mark.parametrize("c,itemsize", [(32, 4), (64, 2), (128, 2),
                                        (256, 2), (512, 2), (512, 4)])
@pytest.mark.parametrize("batch,hw", [(8, 704 * 1280), (8, 88 * 160),
                                      (1, 7), (3, 1000)])
def test_tiles(c, itemsize, batch, hw):
    """A tile is whole steps of the block's pixels (256 threads of 16
    bytes), at most 16; the card gets at least 16 blocks an SM where the
    tensor holds that many steps."""
    rows = 256 * 16 // (c * itemsize)
    tile = gn.tile_pixels(batch, hw, c, itemsize, 132)
    assert tile % rows == 0 and rows <= tile <= 16 * rows
    blocks = batch * -(-hw // tile)
    if batch * hw >= 16 * 132 * rows:
        assert blocks >= 16 * 132
    if tile < 16 * rows:
        assert batch * hw // (rows * 16 * 132) < 16


def _hooked_encode(cfg_kw, dtype, hw=(32, 48), B=2):
    """``AutoencoderKL.encode`` of a seeded NHWC batch, with every
    ``GroupNormSiLU`` of the encoder hooked: each call's input and output
    layout and element count."""
    cfg = PerceptualConfig(compute_dtype=dtype, **cfg_kw)
    model = AutoencoderKL(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(2))
    seen = []
    norms = [m for m in model.encoder.modules()
             if isinstance(m, GroupNormSiLU)]

    def pre(mod, args):
        x = args[0]
        seen.append({"in": x.is_contiguous(memory_format=torch.channels_last),
                     "numel": x.numel(), "silu": mod.silu})

    def post(mod, args, out):
        seen[-1]["out"] = out.is_contiguous(
            memory_format=torch.channels_last)

    handles = [h for m in norms for h in (m.register_forward_pre_hook(pre),
                                          m.register_forward_hook(post))]
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (B,) + hw + (3,)).astype(np.float32))
    with torch.inference_mode():
        moments = model.encode(x)
    for h in handles:
        h.remove()
    return cfg, seen, moments


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg_kw", [TINY, THREE_LEVELS],
                         ids=["tiny", "three_levels"])
def test_encoder_norms_stay_channels_last(cfg_kw, dtype):
    cfg, seen, moments = _hooked_encode(cfg_kw, dtype)
    levels, blocks = len(cfg.ch_mult), cfg.num_res_blocks
    assert len(seen) == 2 * levels * blocks + 6
    assert [s["silu"] for s in seen].count(False) == 1
    for i, s in enumerate(seen):
        assert s["in"] and s["out"], (i, s)
    assert moments.shape == (2, 32 // 2 ** (levels - 1),
                             48 // 2 ** (levels - 1), 8)
