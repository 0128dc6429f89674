"""Parity: the port's VideoSymbolPipeline.run_frames vs svtpu's, on the CPU,
with frames at a resolution the model does not take, so the resize runs."""
import numpy as np
import pytest
import torch

from svtpu.config import rbvae_variant as jax_variant
from svtpu.pipeline import VideoSymbolPipeline as JaxPipeline
from svtpu_torch.config import rbvae_variant
from svtpu_torch.data.symbols import SymbolStore, pack_codes, unpack_codes
from svtpu_torch.models.convert import from_jax_params
from svtpu_torch import pipeline
from svtpu_torch.ops.image import resize_bilinear, resize_u8, to_float01
from svtpu_torch.pipeline import (COPY_CHUNKS, VideoSymbolPipeline,
                                  frame_chunks, preprocess)

from _torch_port import seeded_jax_params

GEOM = dict(input_hw=(32, 32), conv_features=(16, 16, 16))
LATENT = 12


@pytest.fixture(scope="module")
def models():
    jcfg = jax_variant("contrastive", LATENT, **GEOM)
    return jcfg, seeded_jax_params(jcfg, seed=4)


def _frames(n=6, hw=(45, 70), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,),
                                                np.uint8)


def test_run_frames_codes_match_jax(models):
    jcfg, params = models
    frames = _frames()
    ref = JaxPipeline(jcfg, params, noise=False).run_frames(frames)
    tcfg = rbvae_variant("contrastive", LATENT, **GEOM)
    got = VideoSymbolPipeline(tcfg, from_jax_params(params, tcfg),
                              noise=False, device="cpu").run_frames(frames)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == (6, LATENT)
    np.testing.assert_array_equal(got, ref)


def test_run_frames_kernel_routes_match_plain_routes(models):
    """pallas_sampler routes through the sampler kernel's wrapper (its
    plain version here); with noise off its codes are the plain op's."""
    _, params = models
    frames = _frames(seed=1)
    out = {}
    for flag in (False, True):
        cfg = rbvae_variant("contrastive", LATENT, pallas_sampler=flag,
                            **GEOM)
        out[flag] = VideoSymbolPipeline(
            cfg, from_jax_params(params, cfg), noise=False,
            device="cpu").run_frames(frames)
    np.testing.assert_array_equal(out[True], out[False])


def test_noisy_codes_are_seeded_per_batch(models):
    _, params = models
    cfg = rbvae_variant("contrastive", LATENT, pallas_sampler=True, **GEOM)
    pipe = VideoSymbolPipeline(cfg, from_jax_params(params, cfg),
                               temperature=1.0, noise_ratio=3.0,
                               device="cpu")
    frames = _frames(n=16, seed=2)
    a, b = pipe.run_frames(frames, 0), pipe.run_frames(frames, 0)
    c = pipe.run_frames(frames, 1)
    assert set(np.unique(a)) <= {0, 1}
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_host_resize_matches_cv2_inter_linear(models):
    """resize_on="host": the port resizes uint8 frames as the reference's
    ``cv2.resize(..., INTER_LINEAR)`` does, to within cv2's fixed-point
    rounding (one grey level)."""
    cv2 = pytest.importorskip("cv2")
    jcfg, params = models
    frames = _frames(seed=3)
    th, tw = GEOM["input_hw"]
    ref = np.stack([cv2.resize(f, (tw, th), interpolation=cv2.INTER_LINEAR)
                    for f in frames])
    got = resize_u8(torch.from_numpy(frames), (th, tw)).numpy()
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.8
    tcfg = rbvae_variant("contrastive", LATENT, **GEOM)
    codes = VideoSymbolPipeline(tcfg, from_jax_params(params, tcfg),
                                noise=False, resize_on="host",
                                device="cpu").run_frames(frames)
    ref_codes = JaxPipeline(jcfg, params, noise=False,
                            resize_on="host").run_frames(frames)
    assert codes.shape == ref_codes.shape == (6, LATENT)
    assert np.mean(codes == ref_codes) > 0.95


class _StubPercep:
    """A perceptual encoder as ``run_frames`` sees it: frames resized to
    ``input_hw`` on its ``device`` and counted in ``resizes``, one of its
    results a ``frames_per_code`` frames, returned as a CPU tensor."""

    input_hw = (32, 48)
    device = torch.device("cpu")
    frames_per_code = 2
    resizes = 0

    def __init__(self, feats):
        self.feats = feats
        self.seen = []

    def encode_frames(self, frames):
        self.seen.append(frames)
        return self.feats[:-(-len(frames) // self.frames_per_code)]


def test_run_frames_follows_its_perceptual_encoder(models):
    """``run_frames`` resizes frames to the encoder's ``input_hw`` on its
    device (the CPU here) before ``encode_frames``, counts the batch in the
    encoder class's ``resizes``, and puts each code on the encoder's
    ``frames_per_code`` frames, an odd batch's last code on its one
    frame."""
    _, params = models
    cfg = rbvae_variant("contrastive", LATENT, **GEOM)
    feats = torch.rand((3, 32, 32, 3),
                       generator=torch.Generator().manual_seed(6))
    stub = _StubPercep(feats)
    pipe = VideoSymbolPipeline(cfg, from_jax_params(params, cfg),
                               percep=stub, noise=False, device="cpu")
    frames = _frames(n=5)
    resizes = _StubPercep.resizes
    codes = pipe.run_frames(frames)
    assert _StubPercep.resizes == resizes + 1
    (seen,) = stub.seen
    assert seen.dtype == torch.uint8 and seen.device.type == "cpu"
    assert torch.equal(seen, resize_u8(torch.from_numpy(frames), (32, 48)))
    with torch.inference_mode():
        want = pipe._codes((feats,), pipe.temperature, pipe.noise_ratio,
                           None).numpy()
    assert codes.shape == (5, LATENT)
    np.testing.assert_array_equal(codes, np.repeat(want, 2, axis=0)[:5])


@pytest.mark.parametrize("n, hw, whole", [
    (64, (720, 1280), False),       # the HD batch: COPY_CHUNKS chunks
    (63, (720, 1280), False),       # a short last chunk
    (5, (2160, 3840), False),       # few large frames: a frame a chunk
    (64, (256, 256), True),         # host-resized frames, 12.6 MB
    (1, (720, 1280), True),
    (11, (720, 1280), True),        # 30.4 MB, under the threshold
    (0, (720, 1280), True),
])
def test_frame_chunks_cover_the_batch_once_in_order(n, hw, whole):
    """Every frame in one chunk, in order; over ``COPY_CHUNK_BYTES``, at
    most ``COPY_CHUNKS`` chunks of ``ceil(n / COPY_CHUNKS)`` frames, the
    last one shorter; under it, the batch whole."""
    chunks = frame_chunks(n, n * hw[0] * hw[1] * 3)
    assert [i for c in chunks for i in range(n)[c]] == list(range(n))
    sizes = [c.stop - c.start for c in chunks]
    if whole:
        assert sizes == [n]
        return
    size = -(-n // COPY_CHUNKS)
    assert len(sizes) <= COPY_CHUNKS
    assert sizes[:-1] == [size] * (len(sizes) - 1)
    assert 0 < sizes[-1] <= size
    if n == 64:
        assert len(sizes) == COPY_CHUNKS


@pytest.mark.parametrize("n, hw", [(11, (32, 32)), (9, (60, 90))],
                         ids=["down", "up"])
def test_chunked_preprocess_equals_the_whole_batch(monkeypatch, n, hw):
    """The chunked route's preprocessing, chunk by chunk into slices of one
    buffer (the last chunk short), equals the whole batch's
    ``resize_bilinear(to_float01(x))`` bit for bit."""
    monkeypatch.setattr(pipeline, "COPY_CHUNK_BYTES", 0)
    frames = torch.from_numpy(_frames(n=n, seed=6))
    chunks = frame_chunks(n, frames.nbytes)
    assert len(chunks) > 1 and chunks[-1].stop - chunks[-1].start \
        < chunks[0].stop - chunks[0].start
    whole = resize_bilinear(to_float01(frames), hw)
    out = torch.full_like(whole, float("nan"))
    for c in chunks:
        out[c].copy_(preprocess(frames[c], hw))
    assert torch.equal(out, whole)


def test_symbol_store_round_trip(tmp_path):
    codes = np.random.default_rng(5).integers(0, 2, (9, 25), np.uint8)
    np.testing.assert_array_equal(unpack_codes(pack_codes(codes), 25), codes)
    store = SymbolStore(codes, np.arange(100, 109),
                        labels=np.arange(9) % 3)
    store.save(tmp_path / "s.npz")
    back = SymbolStore.load(tmp_path / "s.npz")
    np.testing.assert_array_equal(back.codes, codes)
    np.testing.assert_array_equal(back.code_of(104), codes[4])
    np.testing.assert_array_equal(back.labels, np.arange(9) % 3)
