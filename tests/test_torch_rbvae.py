"""Parity: the port's Seq2SeqBinaryVAE vs svtpu's, on the CPU, with the same
weights carried across by ``from_jax_params``."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.config import rbvae_variant as jax_variant
from svtpu.models.convert_rbvae import convert_rbvae
from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
from svtpu_torch.config import rbvae_variant
from svtpu_torch.models.convert import from_jax_params, load_params_npz
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE

from _torch_port import seeded_jax_params

FLAGSHIP = Path(__file__).resolve().parent.parent / "results" \
    / "p_hardened_params.npz"
LATENT = 6

# Small geometries that keep each variant's structure (kernel size, depth,
# binarization point, final ReLU, noise ratio, LSTM depth); two variants
# also flip a switch the others leave at its default.
CASES = {
    "contrastive": dict(input_hw=(32, 32), conv_features=(16, 16, 16)),
    "triplet": dict(input_hw=(32, 32), conv_features=(16, 16, 16),
                    decoder_sigmoid=False),
    "simple": dict(input_hw=(16, 16), conv_features=(8, 16, 32)),
    "percep": dict(input_hw=(16, 24), conv_features=(16, 16, 16),
                   lstm_residual=True),
}


@functools.lru_cache(maxsize=None)
def _pair(case, compute_dtype="float32"):
    """A JAX model, weights for it from a numpy seed, and the port's model
    holding the same weights through ``from_jax_params``."""
    kw = dict(CASES[case], compute_dtype=compute_dtype)
    jcfg = jax_variant(case, LATENT, **kw)
    tcfg = rbvae_variant(case, LATENT, **kw)
    jmodel = JaxRBVAE(jcfg)
    params = seeded_jax_params(jcfg)
    tmodel = Seq2SeqBinaryVAE(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jcfg, jmodel, params, tmodel


def _frames(cfg, B=2, T=3, seed=0):
    return np.random.default_rng(seed).random(
        (B, T) + tuple(cfg.input_hw) + (cfg.in_channels,), np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    """All four RBVAEOutput fields, noise off and with JAX's own uniform
    draws injected (``bc_rng`` in JAX, ``u`` in the port)."""
    jcfg, jmodel, params, tmodel = _pair(case)
    x = _frames(jcfg)
    key = jax.random.key(3)
    u = np.array(jax.random.uniform(key, x.shape[:2] + (LATENT,),
                                    jnp.float32))
    fwd = jax.jit(lambda p, xx, k: jmodel.apply(
        p, xx, 0.5, False, 0.3, deterministic=True, bc_rng=k))
    for noisy in (False, True):
        ref = fwd(params, jnp.asarray(x), key if noisy else None)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x), 0.5, False, 0.3,
                         deterministic=True,
                         u=torch.from_numpy(u) if noisy else None)
        for name in ref._fields:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=1e-4, atol=1e-4, err_msg=f"{case} {name} noisy={noisy}")


def test_forward_bf16_compute_dtype():
    """bf16 casts sit where the reference puts them: outputs agree to bf16
    resolution."""
    jcfg, jmodel, params, tmodel = _pair("contrastive",
                                         compute_dtype="bfloat16")
    x = _frames(jcfg)
    ref = jax.jit(lambda p, xx: jmodel.apply(p, xx, 0.5, False,
                                             deterministic=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), 0.5, False, deterministic=True)
    for name in ref._fields:
        r = np.asarray(getattr(ref, name).astype(jnp.float32))
        g = getattr(got, name).float().numpy()
        assert getattr(got, name).dtype == torch.bfloat16
        np.testing.assert_allclose(g, r, rtol=0.05, atol=0.05,
                                   err_msg=name)


def _jax_codes(jmodel, params, x):
    """JAX's deterministic hard codes at temperature 0.2, and the values
    they threshold (conv logits for pre_rnn, encoder-LSTM output else)."""

    @jax.jit
    def run(p, xx):
        z = jmodel.apply(p, xx, 0.2, True, method=JaxRBVAE.encode,
                         deterministic=True)
        out = jmodel.apply(p, xx, 0.2, False, deterministic=True)
        pre = out.logits if jmodel.cfg.binarize == "pre_rnn" else out.h_seq
        return z, pre

    z, pre = run(params, jnp.asarray(x))
    return np.asarray(z), np.asarray(pre)


def _codes_bit_identical(jcodes, tcodes, h_over_t):
    """Codes equal everywhere except where the logit sits so close to the
    threshold (|h/T| < 1e-5) that float32 rounding decides it; returns how
    many bits were excluded that way."""
    near = np.abs(h_over_t) < 1e-5
    np.testing.assert_array_equal(tcodes[~near], jcodes[~near])
    return int(near.sum())


@pytest.mark.parametrize("case", list(CASES))
def test_deterministic_codes_bit_identical(case):
    jcfg, jmodel, params, tmodel = _pair(case)
    x = _frames(jcfg, B=4, T=2, seed=1)
    jz, pre = _jax_codes(jmodel, params, x)
    with torch.no_grad():
        tz = tmodel.encode(torch.from_numpy(x), 0.2, True).numpy()
    excluded = _codes_bit_identical(jz, tz, pre / 0.2)
    print(f"{case}: {excluded} of {jz.size} bits excluded (|h/T| < 1e-5)")
    assert excluded <= 1, f"{excluded} bits excluded"


@pytest.mark.parametrize("case", ["contrastive", "simple"])
def test_weight_round_trip_through_convert_rbvae(case):
    jcfg, _, params, tmodel = _pair(case)
    back = convert_rbvae(tmodel.state_dict(), jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path


def test_flagship_archive_codes_bit_identical():
    """results/p_hardened_params.npz in both packages, 2 frames at 256x256
    f32: the port's encode through both kernels' routes (their plain
    versions on the CPU) vs JAX's XLA encode."""
    tree = load_params_npz(FLAGSHIP)
    jcfg = jax_variant("contrastive", 25)
    tcfg = rbvae_variant("contrastive", 25, pallas_trunk=True,
                         pallas_sampler=True)
    tmodel = Seq2SeqBinaryVAE(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(tree, tcfg))
    x = np.random.default_rng(2).random((2, 1, 256, 256, 3), np.float32)
    jz, h = _jax_codes(JaxRBVAE(jcfg), tree, x)
    with torch.no_grad():
        tz = tmodel.encode(torch.from_numpy(x), 0.2, True).numpy()
    assert tz.shape == jz.shape == (2, 1, 25)
    excluded = _codes_bit_identical(jz, tz, h / 0.2)
    assert excluded == 0


def test_conv_final_relu_on_the_kernel_route():
    """``conv_final_relu`` with the trunk kernel: the port ReLUs conv2's
    output on the kernel route as svtpu's XLA route does
    (``svtpu/models/rbvae.py:105-106``); svtpu's Pallas route skips it
    (``:76-80``, ROADMAP.md §D) and is not the reference here. Logits at
    1e-4 and codes bit for bit, on a geometry the kernel takes."""
    jcfg = jax_variant("contrastive", LATENT, conv_final_relu=True)
    params = seeded_jax_params(jcfg, seed=8)
    x = np.random.default_rng(9).random((2, 1, 256, 256, 3), np.float32)
    out = jax.jit(lambda p, xx: JaxRBVAE(jcfg).apply(
        p, xx, 0.2, False, deterministic=True))(params, jnp.asarray(x))
    jz, h = _jax_codes(JaxRBVAE(jcfg), params, x)
    logits = {}
    for relu in (True, False):
        tcfg = rbvae_variant("contrastive", LATENT, pallas_trunk=True,
                             conv_final_relu=relu)
        tmodel = Seq2SeqBinaryVAE(tcfg, device="cpu")
        tmodel.load_state_dict(from_jax_params(params, tcfg))
        with torch.no_grad():
            logits[relu] = tmodel.encoder_cnn(
                torch.from_numpy(x[:, 0]), "kernel").numpy()
            if relu:
                tz = tmodel.encode(torch.from_numpy(x), 0.2, True).numpy()
    ref = np.asarray(out.logits)[:, 0]
    np.testing.assert_allclose(logits[True], ref, rtol=1e-4, atol=1e-4)
    assert not np.allclose(logits[False], ref, rtol=1e-4, atol=1e-4)
    assert _codes_bit_identical(jz, tz, h / 0.2) == 0


@pytest.mark.parametrize("case", [("contrastive", {}),
                                  ("percep", dict(lstm_residual=True))],
                         ids=["contrastive", "percep"])
def test_fresh_lstm_bias_has_svtpus_law(case):
    """A fresh model's summed LSTM bias has svtpu's law, one U(±1/sqrt(H))
    bias a layer (``svtpu/ops/lstm.py:51-61``): ``bias_hh`` starts at 0,
    the sum lies within ±1/sqrt(H), and its std is within 15% of
    1/sqrt(3H) in every layer (4H = 100 draws a layer: ~3.3 standard
    errors of a sample std)."""
    variant, kw = case
    model = Seq2SeqBinaryVAE(rbvae_variant(variant, 25, **kw), device="cpu")
    for name in ("encoder_rnn", "decoder_rnn"):
        lstm = getattr(model, name).lstm
        H = lstm.hidden_size
        for k in range(lstm.num_layers):
            b_ih = getattr(lstm, f"bias_ih_l{k}").detach()
            b_hh = getattr(lstm, f"bias_hh_l{k}").detach()
            b = b_ih + b_hh
            assert torch.equal(b_hh, torch.zeros_like(b_hh)), (name, k)
            assert float(b.abs().max()) <= 1 / np.sqrt(H), (name, k)
            std = float(b.std())
            assert abs(std * np.sqrt(3 * H) - 1) <= 0.15, (name, k, std)
