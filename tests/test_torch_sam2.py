"""SAM 2.1's image encoder on the perceptual path (``models/sam2.py``,
``perceptual/sam2.py``, the windowed attention of ``ops/attention.py``,
``run_frames`` over a ``Sam2Encoder``) against the benchmark's plain
reference (``portbench/reference/sam2.py``), and the reference against
transformers' ``Sam2VisionModel``, on the CPU, in float32, at a small size
that keeps every kind of block at head width 72: a 128x128 image (a 32x32
token grid), widths 72-144-288-576, heads 1-2-4-8, blocks 1-2-3-1, windows
8-4-4-2, queries pooled at the first block of stages 2-4, block 5 global.
"""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import rbvae as ref_rbvae
from portbench.reference import sam2 as ref
from svtpu_torch.config import Sam2HieraConfig, rbvae_variant
from svtpu_torch.models import sam2 as port_sam2
from svtpu_torch.models.sam2 import Sam2ImageEncoder
from svtpu_torch.perceptual.sam2 import Sam2Encoder
from svtpu_torch.pipeline import VideoSymbolPipeline

SMALL = Sam2HieraConfig(image_size=128,
                        embed_dim_per_stage=(72, 144, 288, 576),
                        num_attention_heads_per_stage=(1, 2, 4, 8),
                        blocks_per_stage=(1, 2, 3, 1),
                        window_size_per_stage=(8, 4, 4, 2),
                        global_attention_blocks=(5,),
                        backbone_channel_list=(576, 288, 144, 72),
                        compute_dtype="float32")
CFG = dataclasses.asdict(SMALL)
# float32 through the same operations in another order (the windows copied
# out or read in place, attention in blocks): ~1e-6 at features of ~0.3.
TOL = 2e-5


def _params(seed=3):
    return ref.init_weights(CFG, seed, "cpu")


def _frames(n, seed=0):
    """Frames of 72 x 96, resized to 128 x 128 (up in both sides)."""
    return np.random.default_rng(seed).integers(0, 256, (n, 72, 96, 3),
                                                np.uint8)


def _reference(params, frames):
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        return ref.features(params, CFG, torch.from_numpy(frames))


def test_blocks_of_the_published_and_the_small_config():
    """The published widths: 48 blocks; every head 72 wide; queries pooled
    at blocks 2, 8 and 44 with the previous stage's window; global at 23,
    33, 43; the features 64 x 64. The reference's block list is the
    port's."""
    full = Sam2HieraConfig()
    b = full.blocks
    assert len(b) == 48 and full.feature_hw == 64
    assert all(dout // heads == 72 for _, _, dout, heads, _, _ in b)
    assert [i for i, blk in enumerate(b) if blk[5]] == [2, 8, 44]
    assert [b[i][4] for i in (2, 8, 44)] == [8, 4, 16]
    assert [i for i, blk in enumerate(b) if blk[4] == 0] == [23, 33, 43]
    for cfg in (full, SMALL):
        assert ref.blocks(dataclasses.asdict(cfg)) == [blk[1:]
                                                       for blk in cfg.blocks]


def test_port_matches_the_reference():
    """(a) The whole encode, preprocessing to the FPN level, of 3 frames:
    features within ``TOL``."""
    params, frames = _params(), _frames(3)
    enc = Sam2Encoder(params, SMALL, device="cpu")
    before = Sam2Encoder.frames
    got = enc.encode_frames(frames)
    assert Sam2Encoder.frames == before + 3
    want = _reference(params, frames)
    assert got.shape == want.shape == (3, 8, 8, 256)
    assert float(want.abs().max()) > 0.1
    assert (got - want).abs().max() <= TOL


def test_reference_matches_transformers(monkeypatch):
    """(b) The reference's encoder against transformers' ``Sam2VisionModel``
    (eager attention) loaded from the same state dict, strictly: the FPN's
    level at stage 3's grid, 8x8 here, (``fpn_hidden_states[-1]``) within ``TOL`` on
    the same pixel values. This ties the reference to the published
    equations: the pooled queries and residual, the window partition, the
    windowed position embedding, the neck's top-down sum."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import Sam2HieraDetConfig, Sam2VisionConfig
    from transformers.models.sam2.modeling_sam2 import Sam2VisionModel

    backbone = Sam2HieraDetConfig(
        hidden_size=72, num_attention_heads=1, image_size=[128, 128],
        blocks_per_stage=list(SMALL.blocks_per_stage),
        embed_dim_per_stage=list(SMALL.embed_dim_per_stage),
        num_attention_heads_per_stage=list(
            SMALL.num_attention_heads_per_stage),
        window_size_per_stage=list(SMALL.window_size_per_stage),
        global_attention_blocks=list(SMALL.global_attention_blocks))
    hf = Sam2VisionModel(Sam2VisionConfig(
        backbone_config=backbone,
        backbone_channel_list=list(SMALL.backbone_channel_list),
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]],
        attn_implementation="eager")).eval()
    params = _params()
    hf.load_state_dict(params)
    pixels = ref.preprocess(CFG, torch.from_numpy(_frames(2)))
    with torch.no_grad():
        want = hf(pixel_values=pixels).fpn_hidden_states[-1]
        got = ref.encoder(params, CFG, pixels)
    assert want.shape == (2, 256, 8, 8)
    assert (got - want.permute(0, 2, 3, 1)).abs().max() <= TOL


def test_published_state_dict_names_load():
    """The port's modules carry the published names and shapes: the
    reference's list of them at the published widths (212.7 M parameters,
    the neck's four laterals among them) is the port's, built on the meta
    device, and a state dict in those names loads strictly at the small
    size."""
    full = Sam2HieraConfig()
    shapes = ref.param_shapes(dataclasses.asdict(full))
    assert sum(int(np.prod(s)) for s in shapes.values()) / 1e6 \
        == pytest.approx(212.7, abs=0.05)
    with torch.device("meta"):
        backbone, neck = port_sam2._Backbone(full), port_sam2._Neck(full)
    got = {f"backbone.{k}": tuple(v.shape)
           for k, v in backbone.state_dict().items()}
    got.update({f"neck.{k}": tuple(v.shape)
                for k, v in neck.state_dict().items()})
    assert got == {k: tuple(s) for k, s in shapes.items()}
    model = Sam2ImageEncoder(SMALL, params=_params(), device="cpu")
    assert set(model.state_dict()) == set(_params())


def test_position_table_built_once_and_rebuilt_on_load():
    """The windowed position embedding is built once with the model (from
    the weights it is given) and again by a later ``load_state_dict``,
    never by an encode: the 7x7 table bicubic to the 32x32 grid plus the
    8x8 window tiled 4x4 times, channels last."""
    params = _params()
    before = port_sam2.pos_table.builds
    model = Sam2ImageEncoder(SMALL, params=params, device="cpu")
    assert port_sam2.pos_table.builds == before + 1
    model(torch.zeros(1, 3, 128, 128))
    assert port_sam2.pos_table.builds == before + 1

    def table(p):
        pe = torch.nn.functional.interpolate(
            p["backbone.pos_embed"], size=(32, 32), mode="bicubic")
        pe = pe + p["backbone.pos_embed_window"].repeat(1, 1, 4, 4)
        return pe[0].permute(1, 2, 0)

    assert torch.equal(model.pos_table, table(params))
    other = _params(seed=4)
    model.load_state_dict(other)
    assert port_sam2.pos_table.builds == before + 2
    assert torch.equal(model.pos_table, table(other))


def test_windows_must_tile_the_grid():
    """A grid the windows do not tile (the published code pads it) is
    refused, not padded silently."""
    cfg = dataclasses.replace(SMALL, image_size=96)    # a 24x24 grid, 8 | 24
    model = Sam2ImageEncoder(dataclasses.replace(
        cfg, window_size_per_stage=(8, 5, 4, 2)), device="cpu")
    with pytest.raises(ValueError):
        model(torch.zeros(1, 3, 96, 96))


RBVAE = rbvae_variant("percep", 10, lstm_residual=True, in_channels=256,
                      out_channels=256, input_hw=(8, 8),
                      conv_features=(16, 16, 16))


def test_run_frames_through_the_image_encoder_matches_the_reference():
    """(c) ``run_frames`` with the SAM 2 encoder, noise off, against the
    reference's codes: one code a frame, the frames resized by the encoder
    itself (``input_hw`` None, no resize in ``run_frames``)."""
    params, frames = _params(), _frames(5, seed=5)
    model = dataclasses.asdict(RBVAE)
    weights = ref_rbvae.init_weights(model, 5, "cpu")
    enc = Sam2Encoder(params, SMALL, device="cpu")
    assert enc.input_hw is None and enc.frames_per_code == 1
    pipe = VideoSymbolPipeline(RBVAE, weights, noise=False, device="cpu",
                               percep=enc)
    codes = pipe.run_frames(frames)
    with torch.no_grad():
        logits = ref_rbvae.trunk(weights, model, _reference(params, frames))
        h = ref_rbvae.lstm(weights, "encoder_rnn", model,
                           logits[:, None])[:, 0]
    assert h.abs().min() > 1e-4          # no bit within rounding of 0
    want = (h > 0).numpy().astype(np.uint8)
    assert codes.shape == (5, 10) and np.array_equal(codes, want)
