"""Parity: the port's plain ops (svtpu_torch.ops) vs the JAX package's, on
the CPU with inputs from a numpy seed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.ops import binarize as jbin
from svtpu.ops import image as jimage
from svtpu.ops.lstm import LSTM as JLSTM
from svtpu_torch.ops import binarize as tbin
from svtpu_torch.ops import image as timage
from svtpu_torch.ops.lstm import LSTM as TLSTM


def test_to_float01_exact():
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), np.uint8)
    np.testing.assert_array_equal(
        timage.to_float01(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.to_float01(jnp.asarray(x))))


@pytest.mark.parametrize("src,dst", [((432, 768), (256, 256)),
                                     ((24, 40), (64, 48))],
                         ids=["downscale", "upscale"])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(1).random((2,) + src + (3,), np.float32)
    got = timage.resize_bilinear(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(x), dst))
    assert got.shape == ref.shape == (2,) + dst + (3,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _lstm_pair(rng, D, H, layers, residual):
    jl = JLSTM(H, layers, residual=residual)
    x = rng.normal(size=(3, 5, D)).astype(np.float32)
    params = jl.init(jax.random.key(0), jnp.asarray(x))
    tl = TLSTM(D, H, layers, residual=residual)
    p = params["params"]
    with torch.no_grad():
        for k in range(layers):
            getattr(tl.lstm, f"weight_ih_l{k}").copy_(
                torch.from_numpy(np.asarray(p[f"w_ih_{k}"]).T.copy()))
            getattr(tl.lstm, f"weight_hh_l{k}").copy_(
                torch.from_numpy(np.asarray(p[f"w_hh_{k}"]).T.copy()))
            getattr(tl.lstm, f"bias_ih_l{k}").copy_(
                torch.from_numpy(np.array(p[f"b_{k}"])))
            getattr(tl.lstm, f"bias_hh_l{k}").zero_()
    return jl, params, tl, x


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_lstm_matches_jax(residual):
    jl, params, tl, x = _lstm_pair(np.random.default_rng(2), 8, 8, 2,
                                   residual)
    ref = np.asarray(jl.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _logits(seed, shape=(4, 6, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_binary_concrete_noise_off():
    x = _logits(3)
    for hard in (False, True):
        ref = np.asarray(jbin.binary_concrete(jnp.asarray(x), None, 0.5,
                                              hard, eps=1e-8))
        got = tbin.binary_concrete(torch.from_numpy(x), None, 0.5, hard,
                                   eps=1e-8).numpy()
        if hard:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_binary_concrete_injected_noise():
    """Same uniform draws into both: JAX's own ``u`` for this key goes
    into the port through ``u=``."""
    x = _logits(4)
    key = jax.random.key(5)
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    for hard in (False, True):
        ref = np.asarray(jbin.binary_concrete(jnp.asarray(x), key, 0.2,
                                              hard, eps=1e-8,
                                              noise_scale=0.1))
        got = tbin.binary_concrete(torch.from_numpy(x), None, 0.2, hard,
                                   eps=1e-8, noise_scale=0.1,
                                   u=torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_gumbel_softmax_binary_injected_noise():
    x = _logits(6, (5, 7, 2))
    key = jax.random.key(7)
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    for hard in (False, True):
        ref = np.asarray(jbin.gumbel_softmax_binary(jnp.asarray(x), key, 0.7,
                                                    hard))
        got = tbin.gumbel_softmax_binary(torch.from_numpy(x), None, 0.7, hard,
                                         u=torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_binary_concrete_generator_is_reproducible():
    x = torch.from_numpy(_logits(8))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tbin.binary_concrete(x, g, 0.5, True, noise_scale=1.0)

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
