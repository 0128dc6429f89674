"""Parity: the port's training objectives and Adam step vs svtpu's, on the
CPU, from shared parameters (``from_jax_params``) with dropout off and
JAX's own uniforms injected; and the port's dropout and remat."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from svtpu.config import TrainConfig as JaxTrainConfig
from svtpu.config import rbvae_variant as jax_variant
from svtpu.models.convert_rbvae import convert_rbvae
from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
from svtpu.training import trainer as jtrainer
from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.models.convert import from_jax_params
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE, _dropout
from svtpu_torch.training.trainer import (Noise, Trainer, fold_lstm_biases,
                                          pair_objective, simple_objective)

from _torch_port import ArrayStore, seeded_jax_params

LATENT = 6
PIXEL = dict(input_hw=(32, 32), conv_features=(8, 8, 8))
FLAGSHIP = dict(contrast_on="p", contextfree_contrast=True, l1_logits=0.1,
                margin=3.5, noise_ratio=0.3, beta_kl=0.2, alpha=4.0)

# (variant, model overrides, train-config overrides)
CASES = {
    "contrastive_h": ("contrastive", PIXEL, dict(contrast_on="h")),
    "contrastive_z": ("contrastive", PIXEL, dict(contrast_on="z")),
    "contrastive_p": ("contrastive", PIXEL, dict(contrast_on="p")),
    "flagship": ("contrastive", PIXEL, FLAGSHIP),
    "triplet_l2": ("triplet", PIXEL, dict(objective="triplet", margin=0.5)),
    "triplet_js": ("triplet", PIXEL, dict(objective="triplet",
                                          triplet_distance="js")),
    "triplet_pull_push_ctxfree": ("triplet", PIXEL, dict(
        objective="triplet", triplet_pull=2.0, triplet_push=1.5,
        contextfree_contrast=True, margin=2.0)),
    "percep_residual": ("percep", dict(input_hw=(8, 16),
                                       conv_features=(16, 16, 16),
                                       lstm_layers=2, lstm_residual=True),
                        FLAGSHIP),
}


@functools.lru_cache(maxsize=None)
def _models(variant, model_kw, seed=0):
    kw = dict(model_kw, conv_dropout=0.0)
    jcfg = jax_variant(variant, LATENT, **kw)
    tcfg = rbvae_variant(variant, LATENT, **kw)
    params = seeded_jax_params(jcfg, seed)
    tmodel = Seq2SeqBinaryVAE(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    fold_lstm_biases(tmodel)       # one trainable bias a layer, as svtpu's
    return jcfg, tcfg, params, tmodel


def _batch(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    shape = shape + tuple(cfg.input_hw) + (cfg.in_channels,)
    if cfg.in_channels == 3:
        return rng.integers(0, 256, shape, np.uint8)
    return rng.normal(size=shape).astype(np.float32)


def _uniforms(key, B, S):
    """JAX's Binary-Concrete draws of each pass of ``pair_objective``
    (``svtpu/training/trainer.py:90, 132-134, 203-205``)."""
    _, k_bin = jax.random.split(key)
    shapes = {0: (2 * B, S, LATENT), 1: (2 * B * S, 1, LATENT),
              2: (2 * B * S, 1, LATENT)}
    keys = {0: k_bin, 1: jax.random.fold_in(k_bin, 1),
            2: jax.random.fold_in(k_bin, 2)}
    return {k: torch.from_numpy(np.array(jax.random.uniform(
        keys[k], shapes[k], jnp.float32))) for k in shapes}


def _port_grads(model, jcfg):
    """The port's gradients in svtpu's tree, through ``convert_rbvae``
    (``bias_hh`` holds no gradient: zeros)."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return convert_rbvae(grads, jcfg)


def _assert_grads_close(port_tree, jax_tree, rel=1e-4):
    flat = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    for path, ref in jax.tree_util.tree_leaves_with_path(jax_tree):
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-12)
        err = float(np.abs(flat[path] - ref).max())
        assert err <= rel * scale, (path, err, scale)


def _assert_metrics_close(got, ref, rel=1e-5):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]),
                                   rtol=rel,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_pair_objective_matches_jax(case):
    variant, model_kw, train_kw = CASES[case]
    jcfg, tcfg, params, tmodel = _models(variant,
                                         tuple(sorted(model_kw.items())))
    jtc, ttc = JaxTrainConfig(**train_kw), TrainConfig(**train_kw)
    B, S = 2, 3
    batch = _batch(jcfg, (B, 2, S))
    key = jax.random.key(7)
    temp = 0.7
    jmodel = JaxRBVAE(jcfg)

    def jloss(p):
        return jtrainer.pair_objective(jmodel, jtc, {"params": p},
                                       jnp.asarray(batch), temp, False, key,
                                       deterministic=False)

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params["params"])
    tmodel.zero_grad(set_to_none=True)
    total, metrics = pair_objective(
        tmodel, ttc, torch.from_numpy(batch), temp, False,
        Noise(None, "cpu", _uniforms(key, B, S)), deterministic=False)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    _assert_metrics_close(metrics, jmetrics)
    _assert_grads_close(_port_grads(tmodel, jcfg), {"params": jgrads})


def test_simple_objective_with_padding_mask_matches_jax():
    jcfg, tcfg, params, tmodel = _models(
        "simple", (("conv_features", (8, 16, 32)), ("input_hw", (16, 16))))
    cfg = dict(objective="simple", bernoulli_p=0.1, beta_kl=0.5)
    x = _batch(jcfg, (1, 5))
    mask = np.asarray([[1.0, 1.0, 1.0, 0.0, 0.0]], np.float32)
    key = jax.random.key(3)
    u = np.array(jax.random.uniform(jax.random.split(key)[1],
                                    (1, 5, LATENT), jnp.float32))
    jmodel = JaxRBVAE(jcfg)

    def jloss(p):
        return jtrainer.simple_objective(jmodel, JaxTrainConfig(**cfg),
                                         {"params": p}, jnp.asarray(x), 0.5,
                                         False, key, False,
                                         mask=jnp.asarray(mask))

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params["params"])
    tmodel.zero_grad(set_to_none=True)
    total, metrics = simple_objective(
        tmodel, TrainConfig(**cfg), torch.from_numpy(x), 0.5, False,
        Noise(None, "cpu", {0: torch.from_numpy(u)}), deterministic=False,
        mask=torch.from_numpy(mask))
    total.backward()
    _assert_metrics_close(metrics, jmetrics)
    _assert_grads_close(_port_grads(tmodel, jcfg), {"params": jgrads})


def test_two_adam_steps_match_optax():
    """Two Adam steps through the trainer's own optimizer, from shared
    parameters: the port's parameters, carried back, equal svtpu's. Were
    both of nn.LSTM's biases trained, the folded bias would move twice as
    far as svtpu's one bias, 2 lr apart after two steps (ROADMAP §D)."""
    variant, model_kw, train_kw = CASES["flagship"]
    jcfg, tcfg, params, _ = _models(variant, tuple(sorted(model_kw.items())))
    lr = 3e-4                                  # the flagship's
    jtc = JaxTrainConfig(**train_kw, learning_rate=lr)
    ttc = TrainConfig(**train_kw, learning_rate=lr)
    B, S = 2, 3
    batch = _batch(jcfg, (B, 2, S), seed=4)
    jmodel = JaxRBVAE(jcfg)
    tx = optax.adam(lr)

    @jax.jit
    def jstep(p, opt, key):
        def loss(q):
            return jtrainer.pair_objective(jmodel, jtc, {"params": q},
                                           jnp.asarray(batch), 0.9, False,
                                           key, deterministic=False)[0]
        g = jax.grad(loss)(p)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    store = ArrayStore(np.zeros((20, 32, 32, 3), np.uint8))
    trainer = Trainer(tcfg, ttc, store, _two_state_splits(), (2,),
                      device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(from_jax_params(params, tcfg))
    jp, jopt = params["params"], tx.init(params["params"])
    for s in range(2):
        key = jax.random.key(20 + s)
        jp, jopt = jstep(jp, jopt, key)
        state.optimizer.zero_grad(set_to_none=True)
        total, _ = pair_objective(
            state.model, ttc, torch.from_numpy(batch), 0.9, False,
            Noise(None, "cpu", _uniforms(key, B, S)), deterministic=False)
        total.backward()
        state.optimizer.step()
    back = convert_rbvae(state.model.state_dict(), jcfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, ref in jax.tree_util.tree_leaves_with_path({"params": jp}):
        np.testing.assert_allclose(flat[path], np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=str(path))


def _two_state_splits():
    from svtpu_torch.data.segments import split_segments

    return split_segments(((0, 10), (10, 20)), 0.2, 0.2)


def test_dropout_keeps_share_and_scales():
    gen = torch.Generator().manual_seed(3)
    y = _dropout(torch.ones(1000, 1000), 0.2, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.all(y[kept] == 1.25)
    again = _dropout(torch.ones(1000, 1000), 0.2,
                     torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    other = _dropout(torch.ones(1000, 1000), 0.2,
                     torch.Generator().manual_seed(4))
    assert not torch.equal(y, other)


def _grads_with_dropout(remat: bool, seed: int):
    cfg = rbvae_variant("contrastive", LATENT, remat=remat, **PIXEL)
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_batch(cfg, (2, 3))).float() / 255
    u = torch.from_numpy(np.random.default_rng(2).random(
        (2, 3, LATENT), np.float32))
    out = model(x, 0.7, False, 0.3, u=u, dropout_seed=seed)
    loss = out.x_recon.float().square().mean() + out.h_seq.square().mean()
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gives_the_gradients_of_the_plain_pass_under_dropout():
    """The recompute draws the same masks: checkpointing restores only the
    global generators, so the masks come from a seed drawn before it."""
    plain = _grads_with_dropout(False, 11)
    remat = _grads_with_dropout(True, 11)
    for n, g in plain.items():
        torch.testing.assert_close(remat[n], g, rtol=0, atol=1e-7, msg=n)
    other = _grads_with_dropout(False, 12)
    assert not torch.allclose(other["encoder_cnn.conv.0.weight"],
                              plain["encoder_cnn.conv.0.weight"])


def test_training_forward_needs_a_dropout_seed():
    cfg = rbvae_variant("contrastive", LATENT, **PIXEL)
    model = Seq2SeqBinaryVAE(cfg, device="cpu")
    x = torch.zeros(1, 1, 32, 32, 3)
    with pytest.raises(ValueError, match="dropout_seed"):
        model(x, generator=torch.Generator())
    model(x, generator=torch.Generator(), dropout_seed=1)
    no_drop = dataclasses.replace(cfg, conv_dropout=0.0)
    Seq2SeqBinaryVAE(no_drop, device="cpu")(x, generator=torch.Generator())
