"""Parity: the port's perceptual slice (PerceptualEncoder, interpolation and
the pipeline's percep branch) vs svtpu's, on the CPU, on a tiny
AutoencoderKL and percep RBVAE with the same weights in both packages."""
import functools

import numpy as np
import pytest
import torch

from svtpu.config import PerceptualConfig as JaxPerceptualConfig
from svtpu.config import rbvae_variant as jax_variant
from svtpu.perceptual.embed import PerceptualEncoder as JaxEncoder
from svtpu.perceptual.interpolate import interpolate_images as jax_interp
from svtpu.pipeline import VideoSymbolPipeline as JaxPipeline
from svtpu_torch.config import PerceptualConfig, rbvae_variant
from svtpu_torch.models.autoencoder_kl import DiagonalGaussian
from svtpu_torch.models.convert import from_jax_params as rbvae_weights
from svtpu_torch.ops.image import resize_u8
from svtpu_torch.perceptual.convert import from_jax_params
from svtpu_torch.perceptual.embed import PerceptualEncoder, preprocess_size
from svtpu_torch.perceptual.interpolate import (interpolate_images, lerp,
                                                slerp)
from svtpu_torch.pipeline import VideoSymbolPipeline

from _torch_port import seeded_ae_params, seeded_jax_params

# SD input 96x64 (W x H) → latents 32x48 (one downsample).
TINY = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, compute_dtype="float32", resize_wh=(96, 64))
LATENT = 10
RBVAE = dict(input_hw=(32, 48), conv_features=(16, 16, 16),
             lstm_residual=True)


@functools.lru_cache(maxsize=None)
def _ae():
    jcfg = JaxPerceptualConfig(**TINY)
    params = seeded_ae_params(jcfg, seed=3)
    return jcfg, params, from_jax_params(params, PerceptualConfig(**TINY))


def _encoders(**kw):
    jcfg, params, sd = _ae()
    return (JaxEncoder(params, jcfg, batch_size=4, **kw),
            PerceptualEncoder(sd, PerceptualConfig(**TINY), batch_size=4,
                              device="cpu", **kw))


def _frames(n, hw=(64, 96), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,),
                                                np.uint8)


def test_preprocess_size_snap():
    assert preprocess_size((1280, 720)) == (1280, 704)
    assert preprocess_size((96, 64)) == (96, 64)


def test_encode_frames_matches_jax():
    """Deterministic latents of 6 frames in batches of 4 (a short last
    batch): f32 at 1e-4 on latents of scale ~0.2."""
    jenc, tenc = _encoders(stochastic=False)
    frames = _frames(6)
    ref, got = jenc.encode_frames(frames), tenc.encode_frames(frames)
    assert got.dtype == np.float32 and got.shape == ref.shape == (6, 32, 48, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_decode_latents_matches_jax():
    jenc, tenc = _encoders(stochastic=False)
    z = np.random.default_rng(1).normal(scale=0.2, size=(3, 32, 48, 4)) \
        .astype(np.float32)
    ref, got = jenc.decode_latents(z), tenc.decode_latents(z)
    assert got.shape == ref.shape == (3, 64, 96, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_stochastic_latents_are_seeded():
    """Posterior samples: same seed same draw, a new seed a new one, and
    the draws scatter around the mode by the posterior's std."""
    _, det = _encoders(stochastic=False)
    frames = _frames(4, seed=2)
    mode = det.encode_frames(frames)
    _, a = _encoders(stochastic=True, seed=0)
    _, b = _encoders(stochastic=True, seed=1)
    za, za2, zb = (a.encode_frames(frames), a.encode_frames(frames),
                   b.encode_frames(frames))
    np.testing.assert_array_equal(za, za2)
    assert not np.allclose(za, zb)
    with torch.no_grad():
        x = torch.from_numpy(frames).float() * (2.0 / 255.0) - 1.0
        std = DiagonalGaussian.from_moments(det.model.encode(x)).std.numpy()
    resid = (za - mode) / (det.cfg.scale_factor * std)
    assert abs(resid.mean()) < 0.05 and abs(resid.std() - 1.0) < 0.05


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
def test_interpolate_images_matches_jax(mode, tmp_path):
    jenc, tenc = _encoders(stochastic=False)
    a, b = _frames(2, seed=3)
    ref = jax_interp(jenc, a, b, steps=4, mode=mode)
    got = interpolate_images(tenc, a, b, steps=4, mode=mode,
                             out_path=tmp_path / "interp.png")
    assert got.shape == ref.shape == (4, 64, 96, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    assert (tmp_path / "interp.png").exists()
    # Image paths: lossless files at the SD input size decode to the same
    # frames, so the same pixels come out.
    from PIL import Image

    paths = [tmp_path / f"{n}.png" for n in "ab"]
    for p, f in zip(paths, (a, b)):
        Image.fromarray(f).save(p)
    np.testing.assert_array_equal(
        interpolate_images(tenc, str(paths[0]), paths[1], steps=4,
                           mode=mode), got)


def test_lerp_slerp_endpoints():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(8,)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(lerp(a, b, 0.0), a)
    np.testing.assert_allclose(lerp(a, b, 1.0), b)
    np.testing.assert_allclose(slerp(a, b, 0.0), a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(slerp(a, b, 1.0), b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(slerp(a, a * 2.0, 0.5), lerp(a, a * 2.0, 0.5))


@functools.lru_cache(maxsize=None)
def _percep_rbvae():
    jcfg = jax_variant("percep", LATENT, **RBVAE)
    return jcfg, seeded_jax_params(jcfg, seed=6)


def _block_frames(n, seed):
    """Frames at twice the SD input's size, constant over 2x2 blocks: the
    host resize (cv2's INTER_LINEAR in svtpu, its torch counterpart in the
    port) then lands on pixel values exactly in both packages."""
    small = _frames(n, seed=seed)
    return small.repeat(2, axis=1).repeat(2, axis=2)


@pytest.mark.parametrize("sampler_kernel", [False, True])
def test_percep_run_frames_codes_match_jax(sampler_kernel):
    """svtpu's ``VideoSymbolPipeline(percep=...)`` against the port's, with
    the AE deterministic and noise off: the same codes, bit for bit, from
    frames that need the host resize."""
    jae, tae = _encoders(stochastic=False)
    jcfg, params = _percep_rbvae()
    frames = _block_frames(6, seed=5)
    ref = JaxPipeline(jcfg, params, percep=jae, noise=False) \
        .run_frames(frames)
    tcfg = rbvae_variant("percep", LATENT, pallas_sampler=sampler_kernel,
                         **RBVAE)
    got = VideoSymbolPipeline(tcfg, rbvae_weights(params, tcfg), percep=tae,
                              noise=False, device="cpu").run_frames(frames)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == (6, LATENT)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["mode", "sampled"])
def test_encode_frames_takes_a_tensor_as_it_takes_numpy(stochastic):
    """The same 6 frames (batches of 4, the last padded) as numpy and as a
    tensor on the encoder's device: the same latents, bit for bit, with the
    posterior's mode and with a seeded sample."""
    _, enc = _encoders(stochastic=stochastic, seed=3)
    frames = _frames(6, seed=8)
    want = enc.encode_frames(frames)
    got = enc.encode_frames(torch.from_numpy(frames))
    assert got.shape == want.shape == (6, 32, 48, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["mode", "sampled"])
def test_percep_run_frames_resizes_on_the_encoders_device(stochastic):
    """Frames off the SD input: ``run_frames`` resizes them on the encoder's
    device (the CPU here) and counts one resize; its codes equal, bit for
    bit, those of the same frames resized on the host with ``resize_u8``
    first, which are at the SD input and are not resized again."""
    _, tae = _encoders(stochastic=stochastic, seed=4)
    jcfg, params = _percep_rbvae()
    tcfg = rbvae_variant("percep", LATENT, pallas_sampler=True, **RBVAE)
    pipe = VideoSymbolPipeline(tcfg, rbvae_weights(params, tcfg), percep=tae,
                               temperature=1.0, noise_ratio=3.0,
                               device="cpu")
    frames = _frames(6, hw=(70, 100), seed=9)
    before = PerceptualEncoder.resizes
    got = pipe.run_frames(frames, 5)
    assert PerceptualEncoder.resizes == before + 1
    sd_frames = resize_u8(torch.from_numpy(frames), tae.input_hw).numpy()
    want = pipe.run_frames(sd_frames, 5)
    assert PerceptualEncoder.resizes == before + 1
    assert got.shape == (6, LATENT)
    np.testing.assert_array_equal(got, want)


def test_percep_noisy_codes_are_seeded_per_batch():
    _, tae = _encoders(stochastic=True, seed=2)
    jcfg, params = _percep_rbvae()
    tcfg = rbvae_variant("percep", LATENT, pallas_sampler=True, **RBVAE)
    pipe = VideoSymbolPipeline(tcfg, rbvae_weights(params, tcfg), percep=tae,
                               temperature=1.0, noise_ratio=3.0,
                               device="cpu")
    frames = _frames(8, hw=(70, 100), seed=7)
    a, b, c = (pipe.run_frames(frames, i) for i in (0, 0, 1))
    assert a.shape == (8, LATENT) and set(np.unique(a)) <= {0, 1}
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
