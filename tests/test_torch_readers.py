"""The port's file readers and writers against ``svtpu``'s on the CPU:
``load_frame_pm1``, ``precompute_embeddings`` and ``interpolate_images`` on
image files (the tiny AutoencoderKL of ``tests/test_perceptual_pipeline.py``,
one set of weights in both packages), the SD and RBVAE checkpoint readers,
the npz export and the config JSON.

Latents are held at rtol 1e-3, atol 1e-4 (f32, latents of scale ~0.2, as
``tests/test_torch_perceptual.py``); codes and decoded frames bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import svtpu.config as jconfig
from svtpu.evaluation.common import RBVAEBundle as JaxBundle
from svtpu.models.convert_rbvae import \
    load_rbvae_checkpoint as jax_load_rbvae
from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
from svtpu.perceptual.convert import convert_autoencoder_kl
from svtpu.perceptual.convert import \
    load_torch_checkpoint as jax_load_torch_checkpoint
from svtpu.perceptual.embed import PerceptualEncoder as JaxEncoder
from svtpu.perceptual.embed import load_frame_pm1 as jax_load_frame_pm1
from svtpu.perceptual.embed import \
    precompute_embeddings as jax_precompute
from svtpu.perceptual.interpolate import interpolate_images as jax_interp
from svtpu.training.checkpoints import load_params_npz as jax_load_npz
from svtpu_torch import config as tconfig
from svtpu_torch.evaluation.common import RBVAEBundle
from svtpu_torch.models.convert import (from_jax_params,
                                        load_params_npz,
                                        load_rbvae_checkpoint,
                                        to_jax_params)
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.perceptual.convert import PREFIX
from svtpu_torch.perceptual.convert import from_jax_params as ae_from_jax
from svtpu_torch.perceptual.convert import (load_sd_first_stage,
                                            load_torch_checkpoint)
from svtpu_torch.perceptual.embed import (PerceptualEncoder, load_frame_pm1,
                                          precompute_embeddings)
from svtpu_torch.perceptual.interpolate import interpolate_images
from svtpu_torch.training.checkpoints import save_params_npz

from _torch_port import eval_frames, seeded_ae_params

# tests/test_perceptual_pipeline.py:16-18: SD input 64x64 → latents 32x32.
TINY = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, compute_dtype="float32", resize_wh=(64, 64))
TOL = dict(rtol=1e-3, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _ae():
    """(svtpu config, svtpu params, port config, port state dict)."""
    jcfg = jconfig.PerceptualConfig(**TINY)
    params = seeded_ae_params(jcfg, seed=5)
    tcfg = tconfig.PerceptualConfig(**TINY)
    return jcfg, params, tcfg, ae_from_jax(params, tcfg)


def _jpegs(d, n, hw=(48, 80), seed=0):
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(
            d / f"{i:010d}.jpg")
    return d


@pytest.mark.parametrize("hw, resize_wh", [
    ((37, 53), (64, 64)),          # odd size, upscaled, no snap
    ((101, 67), (70, 45)),         # odd size, snapped to 64x32
    ((720, 1280), (1280, 720)),    # SD's own: snapped to 1280x704
])
def test_load_frame_pm1_bit_identical(tmp_path, hw, resize_wh):
    path = str(_jpegs(tmp_path, 1, hw) / "0000000000.jpg")
    got = load_frame_pm1(path, resize_wh)
    ref = jax_load_frame_pm1(path, resize_wh)
    w, h = (resize_wh[0] // 32 * 32, resize_wh[1] // 32 * 32)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (h, w, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """34 JPEGs: two chunks of the precompute (``max(4 * 4, 32)``)."""
    return _jpegs(tmp_path_factory.mktemp("pframes"), 34)


def test_precompute_embeddings_deterministic_matches_svtpu(frames_dir,
                                                           tmp_path):
    jcfg, params, tcfg, sd = _ae()
    ref = jax_precompute(frames_dir, tmp_path / "ref.npy", params, jcfg,
                         batch_size=4, stochastic=False)
    got = precompute_embeddings(frames_dir, tmp_path / "got.npy", sd, tcfg,
                                batch_size=4, stochastic=False, device="cpu")
    loaded = np.load(tmp_path / "got.npy", allow_pickle=True).item()
    assert sorted(got) == sorted(ref) == sorted(loaded)
    assert len(got) == 34 and "0000000033.jpg" in got
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == ref[k].shape \
            == (1, 4, 32, 32)
        np.testing.assert_array_equal(loaded[k], v)
        np.testing.assert_allclose(v, ref[k], **TOL)


def test_precompute_embeddings_stochastic_is_seeded(frames_dir):
    """Same seed, same draws; another seed, other draws; each chunk draws
    its own (chunk k seeded by ``seed + 32 k``)."""
    _, _, tcfg, sd = _ae()

    def run(seed):
        emb = precompute_embeddings(frames_dir, None, sd, tcfg,
                                    batch_size=4, seed=seed, device="cpu")
        return np.stack([emb[k] for k in sorted(emb)])

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    det = precompute_embeddings(frames_dir, None, sd, tcfg, batch_size=4,
                                stochastic=False, device="cpu")
    det = np.stack([det[k] for k in sorted(det)])
    # Posterior samples scatter about the mode, chunk by chunk.
    assert not np.allclose(a[:32], det[:32]) and \
        not np.allclose(a[32:], det[32:])


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
def test_interpolate_images_on_paths_matches_svtpu(frames_dir, mode):
    jcfg, params, tcfg, sd = _ae()
    a, b = (str(frames_dir / f"{i:010d}.jpg") for i in (0, 7))
    ref = jax_interp(JaxEncoder(params, jcfg, batch_size=4,
                                stochastic=False), a, b, steps=4, mode=mode)
    got = interpolate_images(
        PerceptualEncoder(sd, tcfg, batch_size=4, stochastic=False,
                          device="cpu"), a, b, steps=4, mode=mode)
    assert got.shape == ref.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("layout", ["SD checkpoint", "bare state dict"])
def test_load_torch_checkpoint(tmp_path, layout):
    """A Lightning-style ``{"state_dict": {first_stage_model.* and a UNet
    key}, "global_step": ...}`` and a bare AutoencoderKL state dict both
    give the first stage's weights, as ``svtpu``'s reader does."""
    _, params, tcfg, sd = _ae()
    if layout == "SD checkpoint":
        obj = {"state_dict": {**{PREFIX + k: v for k, v in sd.items()},
                              "model.diffusion_model.out.0.weight":
                                  torch.ones(3)},
               "global_step": 470000}
    else:
        obj = dict(sd)
    path = tmp_path / "sd.ckpt"
    torch.save(obj, path)
    got = load_sd_first_stage(load_torch_checkpoint(path))
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    # svtpu reads the same file to the same weights.
    jparams = convert_autoencoder_kl(jax_load_torch_checkpoint(str(path)),
                                     jconfig.PerceptualConfig(**TINY))
    back = ae_from_jax(jparams, tcfg)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def _rbvae(variant, seed=0):
    """(svtpu config, port config, port state dict with a non-zero
    ``bias_hh``, as a reference checkpoint holds), small geometry."""
    hw = (64, 64) if variant == "simple" else (32, 32)
    jcfg = jconfig.rbvae_variant(variant, latent_dim=6, input_hw=hw)
    tcfg = tconfig.rbvae_variant(variant, latent_dim=6, input_hw=hw)
    sd = Seq2SeqBinaryVAE(tcfg, device="cpu", generator=torch.Generator()
                          .manual_seed(seed)).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if "bias_hh" in k:
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
    return jcfg, tcfg, sd


def _frames(variant):
    if variant == "simple":
        return np.random.default_rng(2).random((12, 64, 64, 3), np.float32)
    return eval_frames()


def _codes_equal(jcfg, params, tcfg, sd, variant):
    """f32 codes of both packages, noise on at ratio 0 (no noise in either
    package for the contrastive variant; the simple variant has no noise
    ratio, so noise off there)."""
    frames = _frames(variant)
    kw = (dict(noise=True, noise_ratio=0.0) if jcfg.has_noise_ratio
          else dict(noise=False))
    ref = JaxBundle(cfg=jcfg, params=params).encode(frames, chunk=8, **kw)
    got = RBVAEBundle(tcfg, sd, device="cpu").encode(frames, chunk=8, **kw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_rbvae_checkpoint_codes_match_svtpu(tmp_path, wrapped):
    jcfg, tcfg, sd = _rbvae("contrastive")
    obj = ({"epoch": 3, "model_state_dict": sd, "consistency_score": 0.9}
           if wrapped else sd)
    path = tmp_path / "best_model.pt"
    torch.save(obj, path)
    got = load_rbvae_checkpoint(path, tcfg)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    _codes_equal(jcfg, jax_load_rbvae(str(path), jcfg), tcfg, got,
                 "contrastive")
    with pytest.raises(RuntimeError):     # the wrong geometry
        load_rbvae_checkpoint(path, tconfig.rbvae_variant(
            "contrastive", latent_dim=7, input_hw=(32, 32)))


@pytest.mark.parametrize("variant", ["contrastive", "simple"])
def test_save_params_npz_loads_in_both_packages(tmp_path, variant):
    """svtpu's loader and model give the port's codes from the port's
    export; the port's own round trip is bit-exact (``bias_hh`` folded into
    ``bias_ih``, as ``from_jax_params`` lays a tree out)."""
    jcfg, tcfg, sd = _rbvae(variant, seed=3)
    path = tmp_path / "m_params.npz"
    save_params_npz(sd, tcfg, path)
    jtree = jax_load_npz(path)
    assert sorted(jtree) == ["params"]
    _codes_equal(jcfg, jtree, tcfg, sd, variant)
    folded = from_jax_params(load_params_npz(path), tcfg)
    save_params_npz(folded, tcfg, tmp_path / "again.npz")
    again = from_jax_params(load_params_npz(tmp_path / "again.npz"), tcfg)
    assert set(again) == set(folded) == set(sd)
    assert all(torch.equal(again[k], v) for k, v in folded.items())
    # The svtpu tree's own shapes: what svtpu's init builds.
    x0 = jnp.zeros((1, 1) + tuple(jcfg.input_hw) + (3,))
    shapes = jax.eval_shape(lambda k: JaxRBVAE(jcfg).init(
        {"params": k}, x0, 1.0, False, deterministic=True),
        jax.random.key(0))
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == \
        jax.tree_util.tree_map(np.shape, jtree)


def test_to_jax_params_inverts_from_jax_params():
    from _torch_port import eval_model

    _, params, tcfg, sd = eval_model()
    tree = to_jax_params(sd, tcfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params)))
    assert len(flat) == len(ref)
    for path, leaf in flat:
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(leaf, ref[path])
    back = from_jax_params(tree, tcfg)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


@pytest.mark.parametrize("make", [
    lambda m: m.rbvae_variant("percep", 25, lstm_residual=True),
    lambda m: m.rbvae_variant("simple", 10, compute_dtype="bfloat16"),
    lambda m: m.TrainConfig(contrast_on="p", l1_logits=0.1, seed=4),
    lambda m: m.PerceptualConfig(ch_mult=(1, 2), resize_wh=(96, 64)),
    lambda m: m.BUILTIN_VIDEOS["chinese_chess"],
], ids=["percep", "simple", "train", "perceptual", "video"])
def test_to_json_matches_svtpu(make):
    cfg = make(tconfig)
    s = tconfig.to_json(cfg)
    assert s == jconfig.to_json(make(jconfig))
    assert tconfig.from_json(type(cfg), s) == cfg
