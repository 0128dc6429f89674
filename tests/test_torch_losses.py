"""Parity: the port's losses and temperature schedule vs svtpu's, on the
CPU, on inputs drawn from a numpy seed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.ops import losses as jl
from svtpu.training.schedules import temperature_schedule as jax_schedule
from svtpu_torch.ops import losses as tl
from svtpu_torch.training.schedules import temperature_schedule

RNG = np.random.default_rng(0)
A, B, C = (RNG.normal(size=(6, 10)).astype(np.float32) for _ in range(3))
PA, PB, PC = (RNG.uniform(0.02, 0.98, (6, 10)).astype(np.float32)
              for _ in range(3))
X4 = RNG.normal(size=(2, 3, 4, 5)).astype(np.float32)
G2 = RNG.normal(size=(4, 10, 2)).astype(np.float32)

# name → (function name, arrays, keyword arguments)
CASES = {
    "recon_mse": ("recon_mse", (X4, X4[::-1].copy()), {}),
    "l1_sparsity": ("l1_sparsity", (A,), dict(lamb=0.3)),
    "kl_binary_concrete": ("kl_binary_concrete", (PA,), dict(p=0.1)),
    "pairwise_distance": ("pairwise_distance", (A, B), {}),
    "pairwise_distance_p1": ("pairwise_distance", (A, B), dict(p=1.0)),
    "cosine_distance": ("cosine_distance", (A, B), {}),
    "contrastive_similar": ("contrastive", (A, B, 0.0), dict(margin=3.5)),
    "contrastive_dissimilar": ("contrastive", (A * 0.2, B * 0.2, 1.0),
                               dict(margin=3.5)),
    "contrastive_cosine": ("contrastive", (A, B, 1.0),
                           dict(margin=0.5, dist="cosine")),
    "triplet_margin_swap": ("triplet_margin", (A, B, C), dict(margin=1.0)),
    "triplet_margin_no_swap": ("triplet_margin", (A, B, C),
                               dict(margin=1.0, swap=False)),
    "js_distance_bernoulli": ("js_distance_bernoulli", (PA, PB), {}),
    "triplet_js": ("triplet_js", (PA, PB, PC), dict(margin=0.1)),
    "kl_binary_gumbel": ("kl_binary_gumbel", (G2,), dict(p=0.1)),
}


def _args(arrays, wrap):
    return [wrap(a) if isinstance(a, np.ndarray) else a for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(case):
    name, arrays, kw = CASES[case]
    ref = np.asarray(getattr(jl, name)(*_args(arrays, jnp.asarray), **kw))
    got = getattr(tl, name)(*_args(arrays, torch.from_numpy), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


GRAD_CASES = {
    "contrastive": ("contrastive", 2, (A, B, 1.0), dict(margin=3.5)),
    "triplet_margin_swap": ("triplet_margin", 3, (A, B, C),
                            dict(margin=1.0, swap=True)),
    "triplet_margin_no_swap": ("triplet_margin", 3, (A, B, C),
                               dict(margin=1.0, swap=False)),
    "triplet_js": ("triplet_js", 3, (PA, PB, PC), dict(margin=0.1)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_gradients_match_jax(case):
    name, n, arrays, kw = GRAD_CASES[case]
    tensors = _args(arrays, lambda a: torch.from_numpy(a).requires_grad_())
    getattr(tl, name)(*tensors, **kw).backward()
    refs = jax.grad(lambda *xs: getattr(jl, name)(*xs, *arrays[n:], **kw),
                    argnums=tuple(range(n)))(*map(jnp.asarray, arrays[:n]))
    for t, ref in zip(tensors[:n], refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("num_steps_to_update", [1, 4])
def test_temperature_schedule_matches_jax(num_steps_to_update):
    for step in range(51):
        kw = dict(init=2.0, final=0.2, anneal_rate=0.05,
                  num_steps_to_update=num_steps_to_update)
        got = temperature_schedule(step, **kw)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jax_schedule(step, **kw)),
                                   rtol=1e-6)
