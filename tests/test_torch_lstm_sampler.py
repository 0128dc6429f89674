"""The encoder LSTM with the sampler fused in (``ops/lstm_cuda.py``), through
its plain version on the CPU: against ``svtpu``'s LSTM followed by its
Pallas sampler in interpret mode, against the port's standalone sampler,
and on the RBVAE encode route, whose codes keep the seed draw and the bits
of the route before the fusion."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.ops.binarize_pallas import binary_concrete_pallas
from svtpu.ops.lstm import LSTM as JLSTM
from svtpu_torch.config import rbvae_variant
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import lstm_cuda
from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
from svtpu_torch.ops.lstm import LSTM as TLSTM

H = 25          # the flagship latent width


def _lstm_pair(seed, layers, residual, hidden=H):
    """svtpu's LSTM and its params from a numpy seed, and the port's LSTM
    holding the same weights (svtpu's one bias as ``bias_ih``)."""
    rng = np.random.default_rng(seed)
    b = 1 / np.sqrt(hidden)
    params = {}
    for k in range(layers):
        for name, shape in ((f"w_ih_{k}", (hidden, 4 * hidden)),
                            (f"w_hh_{k}", (hidden, 4 * hidden)),
                            (f"b_{k}", (4 * hidden,))):
            params[name] = rng.uniform(-b, b, shape).astype(np.float32)
    tl = TLSTM(hidden, hidden, layers, residual=residual)
    with torch.no_grad():
        for k in range(layers):
            w_ih, w_hh, b_ih, b_hh = lstm_cuda.layer_params(tl, k)
            w_ih.copy_(torch.from_numpy(params[f"w_ih_{k}"].T.copy()))
            w_hh.copy_(torch.from_numpy(params[f"w_hh_{k}"].T.copy()))
            b_ih.copy_(torch.from_numpy(params[f"b_{k}"]))
            b_hh.zero_()
    return JLSTM(hidden, layers, residual=residual), {"params": params}, tl


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("layers", [1, 2, 4])
def test_fused_route_matches_svtpu_lstm_and_pallas_sampler(layers, residual,
                                                          steps):
    """f32 h at 1e-5 against svtpu's LSTM; hard codes, noise off, bit for
    bit against svtpu's Pallas sampler (interpret mode) on svtpu's h."""
    jl, params, tl = _lstm_pair(10 * layers + steps, layers, residual)
    x = np.random.default_rng(steps).normal(
        size=(6, steps, H)).astype(np.float32)
    ref_h = jl.apply(params, jnp.asarray(x))
    ref_codes = binary_concrete_pallas(ref_h, seed=0, temperature=0.2,
                                       hard=True, noisy=False, interpret=True)
    with torch.no_grad():
        codes, h = lstm_cuda.lstm_binary_concrete(
            tl, torch.from_numpy(x), 0, 0.2, noisy=False, return_h=True)
    assert codes.shape == h.shape == (6, steps, H)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
def test_noisy_fused_route_is_the_standalone_sampler_on_its_h(seed_kind,
                                                              hard):
    """Noise on: the fused route's codes are the standalone sampler's on the
    same h, element for element, for an int seed and a seed tensor."""
    _, _, tl = _lstm_pair(3, 2, True)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(7, 5, H)).astype(np.float32))
    seed = 123457 if seed_kind == "int" else torch.tensor([123457])
    with torch.no_grad():
        codes, h = lstm_cuda.lstm_binary_concrete(
            tl, x, seed, 0.5, 0.1, hard=hard, eps=1e-8, return_h=True)
        ref = binary_concrete_fused(h, 123457, 0.5, 0.1, hard=hard, eps=1e-8)
        other = lstm_cuda.lstm_binary_concrete(tl, x, 123458, 0.5, 0.1,
                                               hard=hard)
    assert torch.equal(codes, ref)
    assert not torch.equal(codes, other)


def test_plain_version_is_the_two_plain_calls():
    _, _, tl = _lstm_pair(5, 2, False)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 3, H)).astype(np.float32))
    with torch.no_grad():
        codes, h = lstm_cuda.lstm_binary_concrete_plain(tl, x, 9, 0.3, 0.2)
        assert torch.equal(h, tl(x))
        assert torch.equal(codes, binary_concrete_fused(h, 9, 0.3, 0.2))
        assert torch.equal(lstm_cuda.lstm_binary_concrete(tl, x, 9, 0.3, 0.2),
                           codes)


@pytest.mark.parametrize("case", ["contrastive", "percep", "simple",
                                  "contrastive-75"])
def test_encode_keeps_the_codes_of_the_route_before_the_fusion(case):
    """model.encode with the kernel route and a CPU generator: the same
    seed draw from the same generator state, and the same codes, as the
    route that ran the plain LSTM and then the sampler on an int seed.
    Latent 75 (a width the sweeps search) is wider than the fused kernel
    takes, so it runs that route itself."""
    variant, _, width = case.partition("-")
    L = int(width or H)
    geom = {"contrastive": dict(input_hw=(32, 32), conv_features=(8, 8, 8)),
            "percep": dict(input_hw=(16, 24), conv_features=(8, 8, 8),
                           lstm_residual=True),
            "simple": dict(input_hw=(16, 16), conv_features=(4, 8, 8))
            }[variant]
    cfg = rbvae_variant(variant, L, pallas_sampler=True, **geom)
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(7).random(
        (5, 2) + cfg.input_hw + (cfg.in_channels,), np.float32))
    scale = 0.1 if cfg.has_noise_ratio else 1.0
    with torch.no_grad():
        got = model.encode(x, 0.5, True, 0.1, deterministic=False,
                           generator=torch.Generator().manual_seed(11))
        gen = torch.Generator().manual_seed(11)
        logits = model.encoder_cnn(x.reshape((10,) + x.shape[2:])) \
            .reshape(5, 2, L)
        t = logits if cfg.binarize == "pre_rnn" else model.encoder_rnn(logits)
        seed = int(torch.randint(2 ** 31 - 1, (1,), generator=gen))
        ref = binary_concrete_fused(t, seed, 0.5, scale, True, cfg.bc_eps)
    assert got.shape == (5, 2, L)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("hidden, layers, fits", [
    (25, 2, True), (32, 4, True), (50, 2, True), (64, 8, True),
    (75, 2, False), (100, 1, False), (25, 9, False)])
def test_takes_says_which_lstms_the_kernel_fits(hidden, layers, fits):
    """The encode route's dispatch: latents up to 64 and up to 8 layers
    take the fused kernel; the wrapper raises exactly where ``takes`` says
    no."""
    tl = TLSTM(hidden, hidden, layers)
    assert lstm_cuda.takes(tl) is fits
    x = torch.zeros(2, 1, hidden)
    with torch.no_grad():
        if fits:
            lstm_cuda.lstm_binary_concrete(tl, x, 0)
        else:
            with pytest.raises(ValueError):
                lstm_cuda.lstm_binary_concrete(tl, x, 0)


@pytest.mark.parametrize("what", ["hidden>64", "input!=hidden", "float16",
                                  "layers>8"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(what):
    hidden, inp, kw = {"hidden>64": (65, 65, {}),
                       "input!=hidden": (6, 8, {}),
                       "float16": (8, 8, dict(dtype=torch.float16)),
                       "layers>8": (8, 8, dict(num_layers=9))}[what]
    tl = TLSTM(inp, hidden, **kw)
    x = torch.zeros(2, 1, hidden if what != "input!=hidden" else inp)
    assert not lstm_cuda.takes(tl)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_binary_concrete(tl, x, 0)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    _, _, tl = _lstm_pair(8, 2, False)
    before = lstm_cuda.lstm_binary_concrete.launches
    with torch.no_grad():
        lstm_cuda.lstm_binary_concrete(tl, torch.zeros(3, 2, H), 1)
        lstm_cuda.lstm_binary_concrete(tl, torch.zeros(3, 2, H),
                                       torch.tensor([1]))
    assert lstm_cuda.lstm_binary_concrete.launches == before == 0
