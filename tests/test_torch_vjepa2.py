"""V-JEPA 2's encoder on the clip path (``models/vjepa2.py``,
``ops/rope.py``, ``perceptual/clip.py``, the clip branch of
``VideoSymbolPipeline.run_frames``) against the benchmark's plain
reference (``portbench/reference/vjepa2.py``), and the reference against
transformers' ``VJEPA2Model``, on the CPU, in float32, at a tiny size:
hidden 96, 3 heads of 32 (rotary blocks of 10, 2 dims unrotated), 2
layers, clips of 8 frames, crop 32, patch 8 (4 x 4 x 4 tokens)."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import rbvae as ref_rbvae
from portbench.reference import vjepa2 as ref
from svtpu_torch.config import VJEPA2Config, rbvae_variant
from svtpu_torch.ops.rope import rope_block, rope_tables
from svtpu_torch.perceptual.clip import ClipEncoder
from svtpu_torch.pipeline import VideoSymbolPipeline

TINY = VJEPA2Config(crop_size=32, frames_per_clip=8, patch_size=8,
                    hidden_size=96, num_attention_heads=3,
                    num_hidden_layers=2, compute_dtype="float32")
CFG = dataclasses.asdict(TINY)
# q and k scaled by 4, so that the attention logits spread (std ~0.6) as
# the published widths' do at the published init (~0.4 at hidden 1024),
# and the rotary embedding moves the features.
GAINS = {".attention.query.": 4.0, ".attention.key.": 4.0}
# float32 through the same operations in another order.
TOL = 1e-5


def _params(seed=3):
    return ref.init_weights(CFG, seed, "cpu", GAINS)


def _frames(n, seed=0):
    """Frames of 40 x 72: resized to 36 x 64, then cropped to 32 x 32."""
    return np.random.default_rng(seed).integers(0, 256, (n, 40, 72, 3),
                                                np.uint8)


def _reference(params, frames):
    torch.backends.cuda.matmul.allow_tf32 = False
    return ref.features(params, CFG, torch.from_numpy(frames))


def _port(params, frames, tables=None):
    enc = ClipEncoder(params, TINY, device="cpu")
    if tables is not None:
        enc.model.rope_cos.copy_(tables[0])
        enc.model.rope_sin.copy_(tables[1])
    t, h, w = TINY.grid
    return enc.encode_frames(frames).reshape(-1, t * h * w,
                                             TINY.hidden_size)


def test_rope_tables_layout():
    """Blocks of 10 by t, h, w, the angles tiled over each block, the
    2-dim tail unrotated."""
    assert rope_block(32) == 10 and rope_block(64) == 20
    cos, sin = rope_tables((4, 4, 4), 32)
    omega = 10000.0 ** (-torch.arange(5) / 5)
    token = 1 * 16 + 2 * 4 + 3                         # t 1, h 2, w 3
    for b, pos in enumerate((1, 2, 3)):
        want = torch.cat([pos * omega] * 2)
        assert torch.allclose(sin[token, 10 * b:10 * b + 10],
                              torch.sin(want), atol=1e-6)
    assert torch.equal(cos[:, 30:], torch.ones(64, 2))
    assert torch.equal(sin[:, 30:], torch.zeros(64, 2))


def test_port_matches_the_reference():
    """(a) The whole clip encode, preprocessing to the final norm, of 8
    frames (one clip): features within 1e-5."""
    params, frames = _params(), _frames(8)
    got, want = _port(params, frames), _reference(params, frames)
    assert got.shape == want.shape == (1, 64, 96)
    assert (got - want).abs().max() <= TOL


def test_reference_matches_transformers(monkeypatch):
    """(b) The reference's encoder against transformers' ``VJEPA2Model``
    loaded from the same state dict: ``last_hidden_state`` within 1e-5.
    This ties the reference to the published equations: the tiled sin and
    cos, the unrotated tail, the (t, h, w) token order."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers.models.vjepa2.configuration_vjepa2 import \
        VJEPA2Config as HFConfig
    from transformers.models.vjepa2.modeling_vjepa2 import VJEPA2Model

    hf = VJEPA2Model(HFConfig(
        crop_size=32, frames_per_clip=8, patch_size=8, tubelet_size=2,
        hidden_size=96, num_attention_heads=3, num_hidden_layers=2,
        pred_hidden_size=32, pred_num_attention_heads=2,
        pred_num_hidden_layers=1, attn_implementation="eager")).eval()
    params = _params()
    hf.encoder.load_state_dict({k.removeprefix("encoder."): v
                                for k, v in params.items()})
    clips = ref.clips(CFG, torch.from_numpy(_frames(16)))
    with torch.no_grad():
        want = hf(pixel_values_videos=clips,
                  skip_predictor=True).last_hidden_state
        got = torch.cat([ref.encoder(params, CFG, c[None]) for c in clips])
    assert (got - want).abs().max() <= TOL


def _swapped_hw():
    cos, sin = rope_tables((4, 4, 4), 32)
    order = torch.arange(64).view(4, 4, 4).transpose(1, 2).reshape(-1)
    b = slice(10, 30)
    cos[:, b], sin[:, b] = cos[order, b], sin[order, b]
    return cos, sin


def _interleaved():
    cos, sin = rope_tables((4, 4, 4), 32)
    ids = torch.arange(64)
    omega = 10000.0 ** (-torch.arange(5) / 5)
    for b, pos in enumerate((ids // 16, ids % 16 // 4, ids % 4)):
        angle = pos[:, None] * omega.repeat_interleave(2)
        cos[:, 10 * b:10 * b + 10] = angle.cos()
        sin[:, 10 * b:10 * b + 10] = angle.sin()
    return cos, sin


@pytest.mark.parametrize("fault", [_swapped_hw, _interleaved],
                         ids=["h-w-swapped", "sin-cos-interleaved"])
def test_a_wrong_rotary_embedding_fails(fault):
    """(c) The port with its tables swapped between the row and column
    axes, or with the angles interleaved (dims 2j and 2j+1 at one angle)
    where the published code tiles them: (a)'s tolerance fails."""
    params, frames = _params(), _frames(8)
    got = _port(params, frames, fault())
    assert (got - _reference(params, frames)).abs().max() > 100 * TOL


RBVAE = rbvae_variant("percep", 10, lstm_residual=True, in_channels=96,
                      out_channels=96, input_hw=(4, 4),
                      conv_features=(16, 16, 16))


@pytest.mark.parametrize("n", [8, 13])
def test_run_frames_clip_path_matches_the_reference(n):
    """(d) ``run_frames`` with the clip encoder, noise off, against the
    reference's codes: one code a tubelet on both of its frames; 13 frames
    are two clips, the last padded with 3 copies of frame 12, and 13
    codes come back."""
    params, frames = _params(), _frames(n, seed=n)
    model = dataclasses.asdict(RBVAE)
    weights = ref_rbvae.init_weights(model, 5, "cpu")
    pipe = VideoSymbolPipeline(RBVAE, weights, noise=False, device="cpu",
                               percep=ClipEncoder(params, TINY,
                                                  device="cpu"))
    padded, clips = ClipEncoder.padded_frames, ClipEncoder.clips
    codes = pipe.run_frames(frames)
    assert ClipEncoder.clips - clips == -(-n // 8)
    assert ClipEncoder.padded_frames - padded == -n % 8

    feats = ref.tubelets(CFG, _reference(params, frames))
    logits = ref_rbvae.trunk(weights, model, feats)
    h = ref_rbvae.lstm(weights, "encoder_rnn", model, logits[:, None])[:, 0]
    assert h.abs().min() > 1e-4          # no bit within rounding of 0
    want = np.repeat((h > 0).numpy().astype(np.uint8), 2, axis=0)[:n]
    assert codes.shape == (n, 10) and np.array_equal(codes, want)
