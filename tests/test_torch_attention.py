"""Parity: the port's attention (the plain version the wrapper takes on the
CPU, and its backward) vs svtpu's ``blocked_attention``, ``flash_attention``
in interpret mode and ``jax.grad`` of ``attention(use_pallas=False)``."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.ops import attention as jax_attn
from portbench.tracing import kernel_label
from svtpu_torch.ops.attention import (D72_KERNELS, KERNELS, attention,
                                       blocked_attention, flash_attention,
                                       kernel_for, window_attention)


def _qkv(B, N, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, D)).astype(dtype) for _ in range(3)]


def _bf16(arrays):
    """Round f32 arrays to bf16 once, as both packages' inputs."""
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    j = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in t]
    return t, j


@pytest.mark.parametrize("N, chunk", [(100, 32), (100, 1024), (256, 64)])
def test_blocked_matches_jax_blocked_f32(N, chunk):
    """Ragged and whole query chunks; f32 at 1e-4 / 1e-5."""
    q, k, v = _qkv(2, N, 32, seed=N + chunk)
    ref = jax_attn.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                     chunk=chunk)
    got = blocked_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_wrapper_matches_jax_flash_interpret_f32():
    """On a CPU tensor ``flash_attention`` takes the plain version; it
    computes what the Pallas kernel computes (interpret mode)."""
    q, k, v = _qkv(2, 256, 128, seed=2)
    ref = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   block_q=128, block_k=128, interpret=True)
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert flash_attention.launches == before     # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_wrapper_matches_jax_flash_interpret_bf16():
    """bf16 in and out: within one bf16 step at the output's scale (the
    Pallas kernel rounds p to bf16 before p·v; the plain version does
    not)."""
    t, j = _bf16(_qkv(1, 1024, 64, seed=3))
    ref = np.asarray(jax_attn.flash_attention(*j, interpret=True)
                     .astype(jnp.float32))
    got = flash_attention(*t)
    assert got.dtype == torch.bfloat16
    step = 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= step


def test_ragged_n_matches_jax():
    """A length no block divides: svtpu routes it to its blocked version,
    the port's wrapper computes the same function."""
    q, k, v = _qkv(2, 100, 64, seed=4)
    ref = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("N", [96, 1100])
def test_backward_matches_jax_grad(N):
    """The chunked-recompute backward (one chunk, and two with a ragged
    last one) against ``jax.grad`` through svtpu's custom VJP."""
    q, k, v = _qkv(1, N, 32, seed=5)

    def loss(q, k, v):
        return jnp.sum(jax_attn.attention(q, k, v, use_pallas=False) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (attention(*t) ** 2).sum().backward()
    for name, a, b in zip("qkv", t, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_kernel_dispatch_on_dtype_and_width():
    """The launcher's dispatch: the D = 512 wgmma kernel serves the SD
    model's width, the warp-specialised D = 64 kernel V-JEPA 2's heads,
    ``csrc/window_attention.cu``'s global kernel SAM 2's heads of 72, the
    mma.sync kernel every other width. The D = 72 kernels' two routes
    count under keys of their own."""
    assert kernel_for(torch.bfloat16, 512) == "bf16_d512"
    assert kernel_for(torch.bfloat16, 64) == "bf16_d64"
    assert kernel_for(torch.bfloat16, 72) == "bf16_d72"
    for D in (32, 96, 256, 480):
        assert kernel_for(torch.bfloat16, D) == "bf16"
    for D in (64, 512):
        assert kernel_for(torch.float32, D) == "f32"
    assert set(flash_attention.launches_by_kernel) == {
        "bf16_d512", "bf16_d64", "bf16", "f32", "bf16_d72",
        "bf16_d72_window"}
    assert set(KERNELS) | set(D72_KERNELS) \
        == set(flash_attention.launches_by_kernel)
    assert sorted(KERNELS.values()) == list(range(len(KERNELS)))
    assert sorted(D72_KERNELS.values()) == [0, 1]


def _cuda_kernels(src: str) -> dict:
    """Every ``__global__`` function of a CUDA source, by name: its
    namespaces, whether it is a template, and the label a trace gives it
    (``portbench.tracing.kernel_label`` of the name as the profiler
    demangles it, namespaces dropped as the benchmark's readers drop
    them)."""
    raw = src.splitlines()
    lines = [line.split("//")[0] for line in raw]
    out, spaces = {}, []
    for i, line in enumerate(lines):
        opened = re.match(r"namespace\s*(\w*)\s*\{", line)
        if opened:
            spaces.append(opened.group(1) or "(anonymous namespace)")
        elif re.match(r"}\s*//\s*namespace", raw[i]):
            spaces.pop()
        if "__global__" in line:
            head = " ".join(lines[i:i + 3])
            name = re.search(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s*)?(\w+)\s*\(", head).group(1)
            template = lines[i - 1].strip().startswith("template")
            full = ("void " + "::".join(spaces + [name])
                    + ("<64>" if template else "") + "(int)")
            out[name] = dict(spaces=list(spaces), template=template,
                             label=kernel_label(full).rsplit("::", 1)[-1])
    return out


def _launched(src: str, route: str) -> str:
    """The ``__global__`` function that the launcher's branch for
    ``KERNELS[route]`` launches, through the namespace's ``launch``."""
    branch = re.search(r"kernel == %d\)\s*\{\s*return (\w+)::launch\("
                       % KERNELS[route], src)
    ns = branch.group(1)
    body = src[src.index(f"namespace {ns} {{"):
               src.index(f"}}  // namespace {ns}")]
    body = body[body.index("\nint launch("):]
    return re.search(r"(\w+)(?:<\w+>)?<<<", body).group(1)


def test_trace_label_of_the_d64_kernel_is_its_own():
    """The benchmark's readers of the clip cell (``roofline_pct.flash_d64``,
    ``attention_pct.vjepa2``) count the trace label ``flash_bf16_kernel``:
    the kernel launched for ``bf16_d64`` is the only ``__global__`` of
    ``csrc/flash_attention.cu`` with that label, and the D = 512 kernel
    keeps its name, ``flash_d512_kernel``, and its route."""
    src = (Path(__file__).resolve().parent.parent / "svtpu_torch" / "csrc"
           / "flash_attention.cu").read_text()
    kernels = _cuda_kernels(src)
    assert {"flash_d512_kernel", "flash_bf16_kernel", "flash_mma_kernel",
            "flash_f32_kernel"} <= set(kernels)
    labelled = [n for n, k in kernels.items()
                if k["label"] == "flash_bf16_kernel"]
    assert labelled == ["flash_bf16_kernel"]
    d64 = kernels["flash_bf16_kernel"]
    assert d64["spaces"][-1] == "d64"
    assert _launched(src, "bf16_d64") == "flash_bf16_kernel"
    assert kernels["flash_d512_kernel"]["spaces"][-1] == "d512"
    assert kernels["flash_d512_kernel"]["label"] == "flash_d512_kernel"
    assert _launched(src, "bf16_d512") == "flash_d512_kernel"


def test_wrapper_at_the_sd_width_matches_jax_flash_interpret_bf16():
    """D = 512, the width the D = 512 kernel serves, bf16: the plain
    version against the Pallas kernel within one bf16 step; no launch is
    counted on the CPU."""
    t, j = _bf16(_qkv(1, 256, 512, seed=6))
    ref = np.asarray(jax_attn.flash_attention(
        *j, block_q=128, block_k=128, interpret=True).astype(jnp.float32))
    before = dict(flash_attention.launches_by_kernel)
    got = flash_attention(*t)
    assert flash_attention.launches_by_kernel == before
    step = 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= step


def test_wrapper_checks_shapes():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 48), torch.zeros(1, 8, 48),
                        torch.zeros(1, 8, 48))           # D not 32·n
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 544), torch.zeros(1, 8, 544),
                        torch.zeros(1, 8, 544))          # D over 512
    with pytest.raises(ValueError):
        flash_attention(x, torch.zeros(1, 9, 64), x)
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())


def test_d72_kernels_have_labels_of_their_own():
    """The benchmark's SAM 2 readers count the trace labels
    ``window_attn_kernel`` and ``flash_d72_kernel``: the two
    ``__global__`` functions of ``csrc/window_attention.cu``, neither
    label holding ``flash_bf16_kernel`` or ``flash_d512_kernel`` (the clip
    and SD cells' readers' labels)."""
    src = (Path(__file__).resolve().parent.parent / "svtpu_torch" / "csrc"
           / "window_attention.cu").read_text()
    labels = {k["label"] for k in _cuda_kernels(src).values()}
    assert labels == {"window_attn_kernel", "flash_d72_kernel"}
    assert not any("flash_bf16_kernel" in x or "flash_d512_kernel" in x
                   for x in labels)


def test_wrapper_at_d72_takes_fewer_queries_than_keys():
    """D = 72 (SAM 2's heads) passes the checks with ``Nq != Nk``, and the
    plain version computes it (against the product written out); other
    widths keep one shape for q, k and v."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(3, 5, 72, generator=g)
    k, v = (torch.randn(3, 20, 72, generator=g) for _ in range(2))
    before = dict(flash_attention.launches_by_kernel)
    got = flash_attention(q, k, v)
    assert flash_attention.launches_by_kernel == before
    want = torch.softmax(q @ k.transpose(1, 2) / 72 ** 0.5, -1) @ v
    assert got.shape == (3, 5, 72)
    assert (got - want).abs().max() <= 1e-5
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 5, 64), torch.zeros(1, 9, 64),
                        torch.zeros(1, 9, 64))
    with pytest.raises(ValueError):
        flash_attention(q, k, v[:, :10])


@pytest.mark.parametrize("window, pooled", [(4, False), (4, True), (0, False),
                                            (8, True)])
def test_window_attention_plain_against_a_loop(window, pooled):
    """``window_attention`` on the CPU, q, k and v read from one qkv grid
    ``[2, 8, 8, 3 C]`` of 2 heads, the queries max-pooled 2x2 where
    ``pooled``: each window and head against ``softmax(q kᵀ / sqrt(D)) v``
    of its own tokens, written out."""
    heads, C, S = 2, 144, 8
    g = torch.Generator().manual_seed(window + pooled)
    qkv = torch.randn(2, S, S, 3 * C, generator=g)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if pooled:
        q = q.reshape(2, S // 2, 2, S // 2, 2, C).amax(dim=(2, 4))
    got = window_attention(q, k, v, heads, window)
    assert got.shape == q.shape
    wk = window or S
    wq = wk // 2 if pooled else wk
    n = S // wk
    for b in range(2):
        for y in range(n):
            for x in range(n):
                for h in range(heads):
                    c = slice(72 * h, 72 * h + 72)
                    kk = k[b, y * wk:(y + 1) * wk, x * wk:(x + 1) * wk, c]
                    vv = v[b, y * wk:(y + 1) * wk, x * wk:(x + 1) * wk, c]
                    qq = q[b, y * wq:(y + 1) * wq, x * wq:(x + 1) * wq, c]
                    kk, vv, qq = (t.reshape(-1, 72) for t in (kk, vv, qq))
                    o = torch.softmax(qq @ kk.T / 72 ** 0.5, -1) @ vv
                    out = got[b, y * wq:(y + 1) * wq, x * wq:(x + 1) * wq, c]
                    assert (out.reshape(-1, 72) - o).abs().max() <= 1e-5
    with pytest.raises(ValueError):
        window_attention(q, k, v, heads, 3)
