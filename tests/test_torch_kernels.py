"""The port's kernels through their plain versions (no kernel runs on the
CPU) vs the JAX package's Pallas kernels, run as the JAX tests run them on
the CPU (interpret mode)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.ops.binarize_pallas import binary_concrete_pallas
from svtpu.ops.conv_trunk_pallas import fused_conv01 as jax_fused_conv01
from svtpu_torch.ops import binarize_cuda, conv_trunk_cuda


def _trunk_inputs(seed, B=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 256, 256, 3)).astype(np.float32)
    w0 = (rng.normal(size=(3, 3, 3, 64)) * 0.1).astype(np.float32)   # HWIO
    w1 = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    b0, b1 = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    return x, w0, b0, w1, b1


def _torch_trunk_args(x, w0, b0, w1, b1, dtype=torch.float32):
    oihw = lambda w: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        w.transpose(3, 2, 0, 1)))
    return (torch.from_numpy(x).to(dtype), oihw(w0), torch.from_numpy(b0),
            oihw(w1), torch.from_numpy(b1))


def test_fused_conv01_plain_matches_pallas_interpret():
    x, w0, b0, w1, b1 = _trunk_inputs(1)
    ref = np.asarray(jax_fused_conv01(jnp.asarray(x), jnp.asarray(w0),
                                      jnp.asarray(b0), jnp.asarray(w1),
                                      jnp.asarray(b1), interpret=True))
    got = conv_trunk_cuda.fused_conv01(*_torch_trunk_args(x, w0, b0, w1, b1))
    assert got.shape == ref.shape == (1, 64, 64, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_fused_conv01_plain_bf16_rounds_like_pallas():
    """bf16: conv0 (+bias) rounded to bf16 before ReLU, conv1 in f32 with an
    f32 bias, one final rounding — as the TPU path. Sums in another order
    can move a value across a bf16 rounding boundary, so the tolerance is
    two bf16 steps at the output's scale."""
    x, w0, b0, w1, b1 = _trunk_inputs(2)
    ref = np.asarray(jax_fused_conv01(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w0), jnp.asarray(b0),
        jnp.asarray(w1), jnp.asarray(b1), interpret=True).astype(jnp.float32))
    got = conv_trunk_cuda.fused_conv01(
        *_torch_trunk_args(x, w0, b0, w1, b1, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    step = 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=2 * step, rtol=0)
    assert np.mean(got == ref) > 0.99


def test_fused_conv01_rejects_other_geometry():
    args = list(_torch_trunk_args(*_trunk_inputs(3)))
    args[0] = args[0][:, :128]
    with pytest.raises(ValueError):
        conv_trunk_cuda.fused_conv01(*args)


def test_sampler_plain_matches_pallas_interpret_noise_off():
    logits = np.random.default_rng(4).normal(size=(16, 32)).astype(np.float32)
    for hard in (False, True):
        ref = np.asarray(binary_concrete_pallas(
            jnp.asarray(logits), seed=0, temperature=0.5, hard=hard,
            noisy=False, interpret=True))
        got = binarize_cuda.binary_concrete_fused(
            torch.from_numpy(logits), 0, 0.5, hard=hard, noisy=False).numpy()
        if hard:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_philox_known_answer():
    """Random123's published Philox4x32-10 answer for counter 0, key 0: the
    generator the kernel and its plain version share is the standard one."""
    words = binarize_cuda.philox4x32_10(torch.tensor([0]), 0)[0].tolist()
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_sampler_noisy_plain_is_the_formula():
    """The noisy path: the Pallas kernel's on-chip PRNG has no CPU lowering,
    so the plain version is held to the formula on its own Philox ``u``."""
    logits = np.random.default_rng(5).normal(size=(64, 25)).astype(np.float32)
    seed, T, scale, eps = 1234, 0.2, 0.1, 1e-8
    u = binarize_cuda.philox_uniform(logits.size, seed).numpy()
    assert u.min() >= 0 and u.max() < 1 and abs(u.mean() - 0.5) < 0.02
    assert np.all(u * 2 ** 24 == np.floor(u * 2 ** 24))      # 24-bit grid
    noise = np.log(u + eps) - np.log(1 - u + eps)
    soft = 1 / (1 + np.exp(-(logits.reshape(-1) + scale * noise) / T))
    got = binarize_cuda.binary_concrete_fused(
        torch.from_numpy(logits), seed, T, scale, hard=False).numpy()
    np.testing.assert_allclose(got.reshape(-1), soft, rtol=1e-5, atol=1e-6)
    hard = binarize_cuda.binary_concrete_fused(
        torch.from_numpy(logits), seed, T, scale, hard=True).numpy()
    far = np.abs(soft - 0.5) > 1e-4
    np.testing.assert_array_equal(hard.reshape(-1)[far],
                                  (soft > 0.5)[far].astype(np.float32))
    other = binarize_cuda.binary_concrete_fused(
        torch.from_numpy(logits), seed + 1, T, scale, hard=False).numpy()
    assert not np.array_equal(got, other)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = (conv_trunk_cuda.fused_conv01.launches,
              binarize_cuda.binary_concrete_fused.launches)
    conv_trunk_cuda.fused_conv01(*_torch_trunk_args(*_trunk_inputs(6)))
    binarize_cuda.binary_concrete_fused(torch.zeros(8, 25), 3)
    assert (conv_trunk_cuda.fused_conv01.launches,
            binarize_cuda.binary_concrete_fused.launches) == before == (0, 0)
