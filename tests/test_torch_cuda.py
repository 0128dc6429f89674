"""Tests of the port that need an NVIDIA card. They skip without one; on the
card, run them with

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use)."""
import numpy as np
import pytest
import torch

from svtpu_torch.config import rbvae_variant
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.binarize_cuda import binary_concrete_fused


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contrastive", "simple"])
def test_cpu_model_with_a_card_generator_reads_the_drawn_seed(case):
    """A model on the CPU with a generator on the card: the seed drawn on
    the card reaches the plain sampler whole, even while the card is still
    busy with earlier work when the encode draws it."""
    _require_card()
    geom = {"contrastive": dict(input_hw=(32, 32), conv_features=(8, 8, 8)),
            "simple": dict(input_hw=(16, 16), conv_features=(4, 8, 8))}[case]
    cfg = rbvae_variant(case, 25, pallas_sampler=True, **geom)
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(7).random(
        (5, 2) + cfg.input_hw + (cfg.in_channels,), np.float32))
    scale = 0.1 if cfg.has_noise_ratio else 1.0
    with torch.no_grad():
        torch.cuda._sleep(200_000_000)      # keep the card's stream busy
        got = model.encode(x, 0.5, True, 0.1, deterministic=False,
                           generator=torch.Generator("cuda").manual_seed(11))
        gen = torch.Generator("cuda").manual_seed(11)
        seed = int(torch.randint(2 ** 31 - 1, (1,), generator=gen,
                                 device="cuda"))
        logits = model.encoder_cnn(x.reshape((10,) + x.shape[2:])) \
            .reshape(5, 2, 25)
        t = logits if cfg.binarize == "pre_rnn" else model.encoder_rnn(logits)
        ref = binary_concrete_fused(t, seed, 0.5, scale, True, cfg.bc_eps)
    assert torch.equal(got, ref)
