"""Parity: the port's AutoencoderKL (Encoder, Decoder, encode, decode,
DiagonalGaussian) vs svtpu's, on the CPU, with the same weights carried
across by ``from_jax_params``; and an SD-style state dict loaded directly."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.config import PerceptualConfig as JaxPerceptualConfig
from svtpu.models.autoencoder_kl import AutoencoderKL as JaxAE
from svtpu.models.autoencoder_kl import DiagonalGaussian as JaxGaussian
from svtpu.models.autoencoder_kl import Decoder as JaxDecoder
from svtpu.models.autoencoder_kl import Encoder as JaxEncoder
from svtpu.perceptual.convert import convert_autoencoder_kl
from svtpu_torch.config import PerceptualConfig
from svtpu_torch.models.autoencoder_kl import AutoencoderKL, DiagonalGaussian
from svtpu_torch.perceptual.convert import (PREFIX, from_jax_params,
                                            layer_names, load_sd_first_stage)

from _torch_port import seeded_ae_params
from test_autoencoder_kl import TAutoencoderKL

TINY = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2),
            num_res_blocks=1)
# bf16 runs ~20 roundings deep on each side and the two frameworks sum the
# GroupNorm statistics and the convs in other orders, so a value can round
# to a neighbouring bf16 and carry that on: outputs agree within three bf16
# steps at the output's largest magnitude (measured: 2.4 steps at most),
# and within half a step on average (measured: under 0.4).
BF16_STEPS_MAX, BF16_STEPS_MEAN = 3.0, 0.5


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    jcfg = JaxPerceptualConfig(compute_dtype=dtype, **TINY)
    tcfg = PerceptualConfig(compute_dtype=dtype, **TINY)
    params = seeded_ae_params(jcfg)
    model = AutoencoderKL(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    return jcfg, params, model


def _image(B=2, hw=(32, 48), seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B,) + hw + (3,)).astype(np.float32)


def _latent(B=2, hw=(8, 12), seed=1):
    return np.random.default_rng(seed).normal(
        size=(B,) + hw + (4,)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _run(part, dtype):
    """(JAX output, port output) of one part of the autoencoder, NHWC."""
    jcfg, params, model = _pair(dtype)
    p = params["params"]
    with torch.no_grad():
        if part == "encoder":
            x = _image()
            ref = JaxEncoder(jcfg).apply({"params": p["encoder"]}, x)
            got = model.encoder(_nchw(x)).permute(0, 2, 3, 1)
        elif part == "decoder":
            z = _latent()
            ref = JaxDecoder(jcfg).apply({"params": p["decoder"]}, z)
            got = model.decoder(_nchw(z)).permute(0, 2, 3, 1)
        elif part == "encode":
            x = _image(seed=2)
            ref = JaxAE(jcfg).apply(params, x, method=JaxAE.encode)
            got = model.encode(torch.from_numpy(x))
        else:
            z = _latent(seed=3)
            ref = JaxAE(jcfg).apply(params, z, method=JaxAE.decode)
            got = model.decode(torch.from_numpy(z))
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy(), got.dtype


@pytest.mark.parametrize("part", ["encoder", "decoder", "encode", "decode"])
def test_matches_jax_f32(part):
    ref, got, dt = _run(part, "float32")
    assert dt == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("part", ["encoder", "decoder", "encode", "decode"])
def test_matches_jax_bf16(part):
    ref, got, dt = _run(part, "bfloat16")
    assert dt == torch.bfloat16 and got.shape == ref.shape
    step = 2.0 ** -7 * np.abs(ref).max()
    err = np.abs(got - ref)
    assert err.max() <= BF16_STEPS_MAX * step, err.max() / step
    assert err.mean() <= BF16_STEPS_MEAN * step, err.mean() / step


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(4)
    moments = rng.normal(scale=20.0, size=(2, 4, 6, 8)).astype(np.float32)
    ref = JaxGaussian.from_moments(jnp.asarray(moments))
    got = DiagonalGaussian.from_moments(torch.from_numpy(moments))
    for name in ("mean", "logvar", "std"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    assert float(got.logvar.min()) == -30.0 and float(got.logvar.max()) == 20.0
    np.testing.assert_allclose(got.mode().numpy(), np.asarray(ref.mode()))
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(ref.kl()),
                               rtol=1e-5)
    sample = rng.normal(size=(2, 4, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        got.nll(torch.from_numpy(sample)).numpy(),
        np.asarray(ref.nll(jnp.asarray(sample))), rtol=1e-5)
    draw = [got.sample(torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert draw[0].shape == got.mean.shape
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


def test_sd_state_dict_loads_directly():
    """The CompVis-named torch twin, saved as an SD checkpoint's
    ``first_stage_model.*`` tensors (beside unrelated ones), loads into the
    port as it is and encodes/decodes as svtpu does through
    ``convert_autoencoder_kl``."""
    jcfg = JaxPerceptualConfig(compute_dtype="float32", **TINY)
    torch.manual_seed(7)
    twin = TAutoencoderKL(jcfg).eval()
    sd = {PREFIX + k: v for k, v in twin.state_dict().items()}
    sd["model.diffusion_model.out.0.weight"] = torch.ones(3)
    model = AutoencoderKL(PerceptualConfig(compute_dtype="float32", **TINY),
                          device="cpu")
    model.load_state_dict(load_sd_first_stage(sd))
    params = convert_autoencoder_kl({k: v.numpy() for k, v in sd.items()
                                     if k.startswith(PREFIX)}, jcfg)
    x, z = _image(seed=5), _latent(seed=6)
    with torch.no_grad():
        got_m = model.encode(torch.from_numpy(x)).numpy()
        got_x = model.decode(torch.from_numpy(z)).numpy()
        twin_m = twin.quant_conv(twin.encoder(_nchw(x))).permute(0, 2, 3, 1)
    ref_m = np.asarray(JaxAE(jcfg).apply(params, x, method=JaxAE.encode))
    ref_x = np.asarray(JaxAE(jcfg).apply(params, z, method=JaxAE.decode))
    np.testing.assert_allclose(got_m, ref_m, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_x, ref_x, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_m, twin_m.numpy(), rtol=1e-3, atol=1e-4)


def test_weights_round_trip_through_convert_autoencoder_kl():
    _, params, model = _pair("float32")
    back = convert_autoencoder_kl(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JaxPerceptualConfig(**TINY), prefix="")
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path


def test_full_size_names_are_the_compvis_names():
    """At the published widths, the layers the converter walks are exactly
    the CompVis first stage's (the twin's, built without memory)."""
    cfg = PerceptualConfig()
    with torch.device("meta"):
        twin = TAutoencoderKL(JaxPerceptualConfig())
    names = {f"{n}.{p}" for n, _, _ in layer_names(cfg)
             for p in ("weight", "bias")}
    assert names == set(twin.state_dict())
    model = AutoencoderKL(PerceptualConfig(**TINY), device="cpu")
    assert set(model.state_dict()) == set(TAutoencoderKL(
        JaxPerceptualConfig(**TINY)).state_dict())
