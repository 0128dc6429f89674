"""The port's three alternative conv routes against ``svtpu`` on shared
parameters, on the CPU: ``int8_trunk`` (the conv stack's output and the
codes bit for bit in f32; the logits then differ only by the fc's
summation order, as on the plain route), ``conv0_s2d`` and ``deconv_d2s``
(logits and decoder outputs within 1e-5, and one ``pair_objective``
gradient within 1e-5 of the direct route's), the priority of
``pallas_trunk`` over ``int8_trunk``, and the int8 route's refusal to
train."""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from svtpu.config import rbvae_variant as jax_variant
from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
from svtpu.ops.conv import conv2d_int8 as jax_conv2d_int8
from svtpu.ops.conv import conv2d_torch_apply
from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.models import rbvae
from svtpu_torch.models.convert import from_jax_params
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import conv
from svtpu_torch.training.trainer import Noise, fold_lstm_biases, \
    pair_objective

from _torch_port import seeded_jax_params

LATENT = 8
# (variant, geometry): the contrastive trunk at full width (conv fan-in
# 576, f32 accumulation in the plain version) and the simple variant's k4
# trunk (fan-in 2,048, f64 accumulation; ReLU after its last conv).
INT8_CASES = {
    "contrastive": ("contrastive", dict(input_hw=(32, 32))),
    "simple": ("simple", dict(input_hw=(32, 32))),
}
PIXEL = dict(input_hw=(32, 32), conv_features=(16, 16, 16))


@functools.lru_cache(maxsize=None)
def _params(variant, geom):
    return seeded_jax_params(jax_variant(variant, LATENT, **dict(geom)),
                             seed=2)


def _pair(variant, geom=PIXEL, **flags):
    """(svtpu model, its params, the port's model on the same weights)."""
    geom = tuple(sorted(geom.items()))
    params = _params(variant, geom)
    jcfg = jax_variant(variant, LATENT, **dict(geom), **flags)
    tcfg = rbvae_variant(variant, LATENT, **dict(geom), **flags)
    model = Seq2SeqBinaryVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    return JaxRBVAE(jcfg), params, model


def _frames(cfg_hw, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n,) + tuple(cfg_hw) + (3,)).astype(np.float32)


def _jax_logits(jmodel, params, x, trunk):
    return np.asarray(jmodel.apply(
        params, jnp.asarray(x), method=lambda m, v: m.encoder_cnn(
            v, True, trunk)))


# --- int8


def _jax_int8_features(jcfg, params, x):
    """``svtpu``'s int8 trunk (``svtpu/models/rbvae.py:81-95``) up to the
    fc, from its own ops: conv0 in f32, the others by ``conv2d_int8``;
    returned NCHW."""
    p = params["params"]["encoder_cnn"]
    n = len(jcfg.conv_features)
    h = jnp.asarray(x)
    for i in range(n):
        w, b = p[f"conv_{i}"]["kernel"], p[f"conv_{i}"]["bias"]
        op = conv2d_torch_apply if i == 0 else jax_conv2d_int8
        h = op(h, w, b, jcfg.conv_stride, jcfg.conv_padding, jnp.float32)
        if i < n - 1 or jcfg.conv_final_relu:
            h = jax.nn.relu(h)
    return np.asarray(h).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_trunk_and_codes_match_svtpu_bit_for_bit(case):
    variant, geom = INT8_CASES[case]
    jmodel, params, model = _pair(variant, geom, int8_trunk=True)
    x = _frames(geom["input_hw"])
    with torch.no_grad():
        feats = model.encoder_cnn.features(torch.from_numpy(x), "int8")
        got = model.encoder_cnn(torch.from_numpy(x), trunk="int8").numpy()
        direct = model.encoder_cnn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(feats.numpy(),
                                  _jax_int8_features(jmodel.cfg, params, x))
    ref = _jax_logits(jmodel, params, x, "int8")
    # The fc sums 1,024 (contrastive) or 4,096 (simple) products in another
    # order than XLA's dot: a few ulp.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    jcodes = np.asarray(jmodel.apply(
        params, jnp.asarray(x[:, None]), 0.2, True, 0.1,
        method=JaxRBVAE.encode, deterministic=True))
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(x[:, None]), 0.2, True,
                             0.1).numpy()
    np.testing.assert_array_equal(codes, jcodes)
    # The int8 route differs from the f32 one: it really quantises.
    assert np.abs(got - direct).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_int8_matches_svtpu(dtype):
    """One int8 conv alone, f32 and bf16 output: bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 10, 64)).astype(np.float32)       # NHWC
    w = (rng.normal(size=(3, 3, 64, 16)) * 0.1).astype(np.float32)  # HWIO
    b = rng.normal(size=16).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = jax_conv2d_int8(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                          jnp.asarray(b), 2, 1, jdt)
    tdt = getattr(torch, dtype)
    got = conv.conv2d_int8(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt),
                           torch.from_numpy(w).permute(3, 2, 0, 1),
                           torch.from_numpy(b), 2, 1, tdt)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(ref.astype(jnp.float32)))


def test_int8_gemm_route_equals_the_plain_accumulators(monkeypatch):
    """The card's route (im2col of int8, int8 x int8 → int32 GEMMs, in
    chunks of frames) gives the plain version's accumulators exactly, with
    a chunk that leaves a remainder."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, 12, 14, generator=g)
    w = torch.randn(16, 64, 3, 3, generator=g)
    xq, kq, _, _ = conv.int8_quantize(x, w)
    plain = conv.int8_conv_accumulate_plain(xq, kq, 2, 1)
    monkeypatch.setattr(conv, "_INT8_CHUNK_BYTES", 2 * 6 * 7 * 576)
    gemm = conv._int8_conv_gemm(xq, kq, 2, 1)
    assert gemm.dtype == torch.int32 and gemm.shape == (5, 16, 6, 7)
    assert torch.equal(gemm, plain)
    assert int(plain.abs().max()) > 2 ** 16
    assert torch.equal(conv.int8_conv_accumulate(xq, kq, 2, 1), plain)


def test_pallas_trunk_wins_over_int8(monkeypatch):
    """``pallas_trunk`` and ``int8_trunk`` together take the kernel route,
    as ``svtpu``'s ``encode`` does; ``int8_trunk`` alone takes int8."""
    def no_int8(*a, **k):
        raise AssertionError("int8 route taken")

    monkeypatch.setattr(rbvae, "conv2d_int8", no_int8)
    geom = dict(input_hw=(256, 256))
    params = _params("contrastive", tuple(sorted(geom.items())))
    x = torch.from_numpy(_frames((256, 256), n=1))[:, None]
    codes = {}
    for flags in (dict(pallas_trunk=True, int8_trunk=True),
                  dict(pallas_trunk=True)):
        cfg = rbvae_variant("contrastive", LATENT, **geom, **flags)
        model = Seq2SeqBinaryVAE(cfg, device="cpu")
        model.load_state_dict(from_jax_params(params, cfg))
        with torch.no_grad():
            codes[len(flags)] = model.encode(x, 0.2, True)
    assert torch.equal(codes[1], codes[2])
    cfg = rbvae_variant("contrastive", LATENT, **geom, int8_trunk=True)
    model = Seq2SeqBinaryVAE(cfg, device="cpu")
    with torch.no_grad(), pytest.raises(AssertionError, match="int8"):
        model.encode(x, 0.2, True)


def test_int8_route_refuses_training():
    """Inference only, as ``svtpu`` asserts: no dropout, and no gradient
    (round would silently zero it)."""
    _, _, model = _pair("contrastive", int8_trunk=True)
    x = torch.from_numpy(_frames(PIXEL["input_hw"]))
    with pytest.raises(ValueError, match="inference-only"):
        model.encoder_cnn(x, trunk="int8")              # grad enabled
    with torch.no_grad(), pytest.raises(ValueError, match="inference-only"):
        model.encoder_cnn(x, trunk="int8", dropout_seed=1)
    with pytest.raises(ValueError, match="inference-only"):
        model.encode(x[:, None], 0.2, True)
    # The training pass never takes it: forward runs the plain trunk.
    out = model(x[:, None], 0.5, False, deterministic=True)
    out.x_recon.mean().backward()
    assert model.encoder_cnn.fc.weight.grad.abs().sum() > 0


# --- s2d and d2s


def test_s2d_logits_match_svtpu():
    jmodel, params, model = _pair("contrastive", conv0_s2d=True)
    x = _frames(PIXEL["input_hw"])
    ref = _jax_logits(jmodel, params, x, "xla")
    with torch.no_grad():
        got = model.encoder_cnn(torch.from_numpy(x)).numpy()
        direct = Seq2SeqBinaryVAE(
            rbvae_variant("contrastive", LATENT, **PIXEL), device="cpu")
        direct.load_state_dict(model.state_dict())
        plain = direct.encoder_cnn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)


def test_d2s_decoder_matches_svtpu():
    jmodel, params, model = _pair("contrastive", deconv_d2s=True)
    z = np.random.default_rng(3).uniform(0, 1, (5, LATENT)) \
        .astype(np.float32)
    ref = np.asarray(jmodel.apply(
        params, jnp.asarray(z), method=lambda m, v: m.decoder_cnn(v, True)))
    with torch.no_grad():
        got = model.decoder_cnn(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape, stride, pad, s2d", [
    ((2, 5, 9, 8), 2, 1, False),     # odd H: the direct conv
    ((2, 5, 8, 8), 1, 1, False),     # stride 1: the direct conv
    ((2, 5, 8, 10), 2, 1, True),
])
def test_s2d_applies_only_where_svtpu_applies_it(shape, stride, pad, s2d):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    w = torch.randn(7, 5, 3, 3, generator=g, dtype=torch.float64)
    b = torch.randn(7, generator=g, dtype=torch.float64)
    assert conv._s2d_applies(x, w, stride, pad) == s2d
    got = conv.conv2d_torch(x, w, b, stride, pad, torch.float64, s2d=True)
    ref = conv.conv2d_torch(x, w, b, stride, pad, torch.float64)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


def test_d2s_applies_only_at_k3s2p1op1():
    """The simple variant's k4/op0 stages keep the direct transposed conv;
    k3/s2/p1/op1 gives the direct result in f64."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 5, 7, generator=g, dtype=torch.float64)
    b = torch.zeros(4, dtype=torch.float64)
    for k, op in ((3, 1), (4, 0)):
        w = torch.randn(6, 4, k, k, generator=g, dtype=torch.float64)
        got = conv.conv_transpose2d_torch(x, w, b, 2, 1, op, torch.float64,
                                          d2s=True)
        ref = F.conv_transpose2d(x, w, b, 2, 1, op)
        assert got.shape == ref.shape == (2, 4, 10, 14)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


def test_s2d_d2s_pair_objective_gradient_matches_the_direct_route():
    """One flagship-style ``pair_objective`` step with dropout on, the s2d
    and d2s model under ``remat`` against the direct model without it:
    loss and every gradient within 1e-5 of the largest."""
    geom = dict(PIXEL, conv_dropout=0.1)
    params = _params("contrastive", tuple(sorted(PIXEL.items())))
    batch = np.random.default_rng(4).integers(
        0, 256, (2, 2, 3, 32, 32, 3), np.uint8)
    tc = TrainConfig(contrast_on="p", contextfree_contrast=True,
                     l1_logits=0.1, margin=3.5, noise_ratio=0.3, alpha=4.0)
    grads, totals = [], []
    for flags in (dict(conv0_s2d=True, deconv_d2s=True, remat=True), {}):
        cfg = rbvae_variant("contrastive", LATENT, **geom, **flags)
        model = Seq2SeqBinaryVAE(cfg, device="cpu")
        model.load_state_dict(from_jax_params(params, cfg))
        fold_lstm_biases(model)
        total, _ = pair_objective(model, tc, torch.from_numpy(batch), 0.7,
                                  False, Noise(11, "cpu"),
                                  deterministic=False)
        total.backward()
        totals.append(float(total.detach()))
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert totals[0] == pytest.approx(totals[1], rel=1e-5)
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for name, g in grads[1].items():
        scale = max(float(g.abs().max()), 1e-12)
        assert float((grads[0][name] - g).abs().max()) <= 1e-5 * scale, name
