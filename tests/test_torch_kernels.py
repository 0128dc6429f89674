"""The port's kernels through their plain versions (no kernel runs on the
CPU) vs the JAX package's Pallas kernels, run as the JAX tests run them on
the CPU (interpret mode)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _gemm_conv_s2(h, wm, cin, depth):
    """k3/s2/p1 conv as the kernels' implicit GEMM: im2col rows of depth
    ``k = (ky * 3 + kx) * cin + ci`` (zero-padded to ``depth``) times the
    ``[cout, depth]`` weight matrix ``wm``; NCHW in and out."""
    B, _, H, W = h.shape
    hp = F.pad(h, (1, 1, 1, 1))
    taps = [hp[:, :, ky:ky + H:2, kx:kx + W:2]
            for ky in range(3) for kx in range(3)]
    a = torch.stack(taps, 1).permute(0, 3, 4, 1, 2).reshape(
        B, H // 2, W // 2, 9 * cin)
    a = F.pad(a, (0, depth - 9 * cin))
    return (a @ wm.t()).permute(0, 3, 1, 2)


def _read_packed_w1(packed):
    """The ``[64, 576]`` weight matrix as the kernel reads the packed
    layout: logical chunk ``k // 8`` of row ``co`` at ``(k // 8) ^ (co % 8)``."""
    co = torch.arange(64)[:, None]
    k = torch.arange(576)[None, :]
    return packed[co, ((k // 8) ^ (co % 8)) * 8 + k % 8]


@pytest.mark.parametrize("which", ["w0", "w1"])
def test_packed_weights_as_implicit_gemm_equal_conv2d(which):
    """The kernels' GEMMs on the packed weights, emulated in f32, are the
    convolutions."""
    rng = np.random.default_rng(8)
    cin = 3 if which == "w0" else 64
    # The trunk's weight scale (conv outputs of order 1).
    w = torch.from_numpy((rng.normal(size=(64, cin, 3, 3)) * 0.05)
                         .astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2, cin, 16, 16)).astype(np.float32))
    if which == "w0":
        wm, depth = conv_trunk_cuda.pack_w0(w, torch.float32), 32
        assert wm.shape == (64, 32) and not wm[:, 27:].any()
    else:
        wm = _read_packed_w1(conv_trunk_cuda.pack_w1(w, torch.float32))
        depth = 576
    got = _gemm_conv_s2(h, wm, cin, depth)
    ref = F.conv2d(h, w, None, 2, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_weight_packing_round_trips_exactly():
    rng = np.random.default_rng(9)
    w0 = torch.from_numpy(rng.normal(size=(64, 3, 3, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(64, 64, 3, 3)).astype(np.float32))
    p0, p1 = conv_trunk_cuda.pack_w0(w0), conv_trunk_cuda.pack_w1(w1)
    assert p0.dtype == p1.dtype == torch.bfloat16
    assert p0.shape == (64, 32) and p1.shape == (64, 576)
    assert p0.is_contiguous() and p1.is_contiguous()
    assert torch.equal(conv_trunk_cuda.unpack_w0(p0), w0.to(torch.bfloat16))
    assert torch.equal(conv_trunk_cuda.unpack_w1(p1), w1.to(torch.bfloat16))
    # The swizzle moves chunks: row 1's first 8 values are logical chunk 1.
    ref = w1.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(64, 576)
    assert torch.equal(p1[0], ref[0])
    assert torch.equal(p1[1, :8], ref[1, 8:16])


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_weights_layouts(dtype):
    """bf16: the tensor-core kernel's packed GEMM layouts; f32: HWIO. Both
    contiguous, b0 in the input dtype and b1 in f32."""
    _, w0, b0, w1, b1 = _torch_trunk_args(*_trunk_inputs(10))
    w0k, b0k, w1k, b1k = conv_trunk_cuda.kernel_weights(dtype, w0, b0, w1, b1)
    if dtype == torch.bfloat16:
        assert torch.equal(w0k, conv_trunk_cuda.pack_w0(w0))
        assert torch.equal(w1k, conv_trunk_cuda.pack_w1(w1))
    else:
        assert torch.equal(w0k, w0.permute(2, 3, 1, 0))
        assert torch.equal(w1k, w1.permute(2, 3, 1, 0))
    assert all(t.is_contiguous() for t in (w0k, b0k, w1k, b1k))
    assert b0k.dtype == dtype and b1k.dtype == torch.float32
    assert torch.equal(b1k, b1)


def test_kernel_weights_follow_an_in_place_update():
    _, w0, b0, w1, b1 = _torch_trunk_args(*_trunk_inputs(11))
    first = conv_trunk_cuda.kernel_weights(torch.bfloat16, w0, b0, w1, b1)
    w1.mul_(2.0)
    updated = conv_trunk_cuda.kernel_weights(torch.bfloat16, w0, b0, w1, b1)
    assert torch.equal(updated[2], conv_trunk_cuda.pack_w1(w1))
    assert not torch.equal(updated[2], first[2])


def test_packed_w1_rows_of_one_ldmatrix_hit_eight_bank_groups():
    """ldmatrix reads one 16-byte chunk from each of 8 consecutive rows:
    the swizzle stores each logical chunk of those rows at 8 distinct
    positions modulo 8, so the 8 reads fall in 8 bank groups."""
    w1 = torch.arange(64 * 576, dtype=torch.float32).reshape(64, 3, 3, 64) \
        .permute(0, 3, 1, 2)
    logical = w1.permute(0, 2, 3, 1).reshape(64, 72, 8)[:, :, 0]
    stored = conv_trunk_cuda.pack_w1(w1, torch.float32).reshape(64, 72, 8)
    where = torch.empty(64, 72, dtype=torch.long)
    for co in range(64):
        pos = {int(v): i for i, v in enumerate(stored[co, :, 0])}
        where[co] = torch.tensor([pos[int(v)] for v in logical[co]])
    for g in range(8):
        rows = where[8 * g:8 * g + 8] % 8
        assert all(len(set(rows[:, c].tolist())) == 8 for c in range(72))
