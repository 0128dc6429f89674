"""Single-head spatial attention for the AutoencoderKL mid-block: the
hand-written CUDA kernel (``csrc/flash_attention.cu``), its plain PyTorch
version and the differentiable ``attention`` that the model calls.

Counterpart of ``svtpu/ops/attention.py``: non-causal
``softmax(q kᵀ / sqrt(D)) v`` on ``q, k, v [B, N, D]``. At the SD encoder's
bottleneck N = 88·160 = 14,080 tokens of width D = 512, so the ``[N, N]``
score matrix (~800 MB in f32 per image) never reaches device memory in the
kernel. Rounding is that of ``_flash_kernel`` (``attention.py:36-55``):
q kᵀ in the input dtype accumulated in f32, scaled in f32, online softmax
in f32 with the denominator summing the unrounded ``p``, ``p`` rounded to
the input dtype before the p·v product (accumulated in f32), and the
output ``acc / l`` cast once to the input dtype.

``flash_attention`` takes the plain version (``blocked_attention``) for a
CPU tensor and the kernel for a CUDA tensor; it counts its kernel launches
in ``flash_attention.launches``, and by kernel (``kernel_for``) in
``flash_attention.launches_by_kernel``. ``attention`` is a
``torch.autograd.Function`` whose backward is the query-chunked recompute
of ``_attention_bwd_chunked`` (``attention.py:157-206``), as torch ops.
"""
from __future__ import annotations

import ctypes
import math

import torch

from svtpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# The kernels of csrc/flash_attention.cu, by the launcher's index.
KERNELS = {"f32": 0, "bf16": 1, "bf16_d512": 2, "bf16_d64": 3}
_SIGNATURES = {"svt_flash_attention": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
    ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])}
MAX_D = 512


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = 1024) -> torch.Tensor:
    """The plain version (``attention.py:133-154``): query chunks, f32
    scores and softmax, the output cast to the input dtype; peak memory
    O(chunk · N). On a card this needs TF32 off to be float32."""
    N, D = q.shape[1:]
    scale = 1.0 / math.sqrt(D)
    kT = k.float().transpose(1, 2)
    vf = v.float()
    out = [torch.bmm(torch.softmax(torch.bmm(q[:, s:s + chunk].float(), kT)
                                   * scale, dim=-1), vf).to(q.dtype)
           for s in range(0, N, chunk)]
    return torch.cat(out, dim=1) if out else torch.empty_like(q)


def attention_bwd_chunked(q, k, v, g, chunk: int = 1024):
    """Memory-bounded attention backward (``attention.py:157-187``):
    recompute the softmax one query chunk at a time, in f32."""
    N, D = q.shape[1:]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, gf = (a.float() for a in (q, k, v, g))
    dq, dk, dv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    for s in range(0, N, chunk):
        qb, gb = qf[:, s:s + chunk], gf[:, s:s + chunk]
        p = torch.softmax(torch.bmm(qb, kf.transpose(1, 2)) * scale, dim=-1)
        dp = torch.bmm(gb, vf.transpose(1, 2))
        dv += torch.bmm(p.transpose(1, 2), gb)
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        dq.append(torch.bmm(ds, kf) * scale)
        dk += torch.bmm(ds.transpose(1, 2), qb) * scale
    dq = torch.cat(dq, dim=1) if dq else torch.zeros_like(qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one [B, N, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    D = q.shape[-1]
    if D % 32 or not 32 <= D <= MAX_D:
        raise ValueError(f"D must be a multiple of 32 up to {MAX_D}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")


def kernel_for(dtype: torch.dtype, D: int) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that runs these inputs:
    ``bf16_d512``, the wgmma kernel for the SD model's width; ``bf16_d64``,
    the warp-specialised wgmma kernel for V-JEPA 2's heads; ``bf16``, the
    mma.sync kernel, for every other D; ``f32``, the CUDA-core kernel. The
    wrapper passes the choice to the launcher."""
    if dtype == torch.float32:
        return "f32"
    return {512: "bf16_d512", 64: "bf16_d64"}.get(D, "bf16")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Plain, contiguous, on a 16-byte boundary (the kernel's vector
    loads)."""
    t = _build.plain(t).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(D)) v`` in one kernel on the card.

    CPU tensor: the plain version. CUDA tensor: the kernel (any N; the
    ragged tail is masked inside it), or an exception — there is no
    fallback. Inference only: ``attention`` carries the gradient.

    Under a CUDA graph's capture (the clip encoder's encode,
    ``models/encode_graph.py``) the D = 512 and D = 64 kernels' TMA maps
    are encoded on the host from ``q``, ``k`` and ``v``'s addresses,
    which then lie in the graph's pool and stay fixed, and the
    maps travel in the captured launch's parameters: every replay reads the
    tensors the capture made.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return blocked_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, N, D = q.shape
    out = torch.empty_like(q)
    if B == 0 or N == 0:
        return out
    fn = _build.load("flash_attention", _SIGNATURES).svt_flash_attention
    kernel = kernel_for(q.dtype, D)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, N, D, KERNELS[kernel], 1.0 / math.sqrt(D),
                 _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(KERNELS, 0)


class Attention(torch.autograd.Function):
    """``flash_attention`` (or ``blocked_attention``) forward, chunked
    recompute backward — ``_attention_ad`` (``attention.py:190-206``)."""

    @staticmethod
    def forward(ctx, q, k, v, use_kernel: bool):
        ctx.save_for_backward(q, k, v)
        if use_kernel:
            return flash_attention(q, k, v)
        return blocked_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return attention_bwd_chunked(*ctx.saved_tensors, g) + (None,)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              use_kernel: bool = True) -> torch.Tensor:
    """Differentiable attention: the kernel's wrapper forward (the plain
    version with ``use_kernel=False``, as ``use_pallas=False`` is in
    ``svtpu``), the chunked recompute backward."""
    return Attention.apply(q, k, v, use_kernel)
