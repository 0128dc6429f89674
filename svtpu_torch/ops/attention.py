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

Head width 72 (SAM 2.1's Hiera encoder, ``models/sam2.py``) has kernels of
its own (``csrc/window_attention.cu``): ``window_attention`` attends
inside the windows of channels-last token grids, queries and keys read
where the model's qkv product left them, with fewer queries than keys
where the queries were pooled, or over the whole grid (global
attention); ``flash_attention`` at D = 72 takes the same code on ``[B, N,
D]``, with ``Nq`` queries and ``Nk`` keys. Their launches count in
``flash_attention``'s counters, under ``bf16_d72`` (global, the trace's
``flash_d72_kernel``) and ``bf16_d72_window`` (``window_attn_kernel``).
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
# The kernels of csrc/window_attention.cu (bf16, D = 72), by the
# launcher's ``global_`` flag.
D72 = 72
D72_KERNELS = {"bf16_d72_window": 0, "bf16_d72": 1}
_LL, _I = ctypes.c_longlong, ctypes.c_int
_D72_SIGNATURES = {"svt_window_attention": (ctypes.c_int, [
    ctypes.c_void_p] * 4 + [_LL, _I] * 3 + [_I] * 11 + [
    ctypes.c_float, ctypes.c_void_p])}


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
    """q, k, v of one ``[B, N, D]`` shape, D a multiple of 32 up to
    ``MAX_D``; or D = 72, where q may hold another number of rows than k
    and v (``[B, Nq, 72]``, ``[B, Nk, 72]``)."""
    if q.dim() != 3 or k.shape != v.shape or q.shape[::2] != k.shape[::2] \
            or (q.shape != k.shape and q.shape[-1] != D72):
        raise ValueError(f"q, k, v must be one [B, N, D] shape (at D = 72 "
                         f"q may have other N), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    D = q.shape[-1]
    if (D % 32 or not 32 <= D <= MAX_D) and D != D72:
        raise ValueError(f"D must be a multiple of 32 up to {MAX_D}, or "
                         f"{D72}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")


def kernel_for(dtype: torch.dtype, D: int) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that runs these inputs:
    ``bf16_d512``, the wgmma kernel for the SD model's width; ``bf16_d64``,
    the warp-specialised wgmma kernel for V-JEPA 2's heads; ``bf16_d72``,
    ``csrc/window_attention.cu``'s global kernel for SAM 2's heads;
    ``bf16``, the mma.sync kernel, for every other D; ``f32``, the
    CUDA-core kernel. The wrapper passes the choice to the launcher."""
    if dtype == torch.float32:
        return "f32"
    return {512: "bf16_d512", 64: "bf16_d64", D72: "bf16_d72"}.get(D, "bf16")


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
    if q.shape[-1] == D72:
        # One window a row of the batch: [B, 1, N] grids.
        out = torch.empty_like(q)
        _launch_d72(q[:, None], k[:, None], v[:, None], out[:, None], 1,
                    (1, q.shape[1]), (1, k.shape[1]), "bf16_d72")
        return out
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
flash_attention.launches_by_kernel = dict.fromkeys(
    list(KERNELS) + list(D72_KERNELS), 0)


def _launch_d72(q, k, v, out, heads: int, q_win: tuple, k_win: tuple,
                kernel: str) -> None:
    """One launch of ``csrc/window_attention.cu`` on channels-last grids
    ``q``, ``out`` ``[B, Hq, Wq, C]`` and ``k``, ``v`` ``[B, H, W, C]``
    (``C = 72 heads``, the last dim contiguous), windows of ``q_win`` and
    ``k_win`` tokens (rows, columns) tiling both grids alike."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.bfloat16 or t.device.type != "cuda":
            raise TypeError(f"the D = 72 kernels take bfloat16 CUDA "
                            f"tensors, got {name} {t.dtype} on {t.device}")
        if t.stride(3) != 1 or t.stride(1) != t.shape[2] * t.stride(2) \
                or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the last dim must be contiguous, the "
                             f"grid's rows dense and every stride a multiple "
                             f"of 8 elements from a 16-byte boundary; got "
                             f"strides {t.stride()}")
    if k.stride() != v.stride():
        raise ValueError("k and v must have one layout")
    B, H, W, C = k.shape
    if not B or not H * W or not q.shape[1] * q.shape[2]:
        return
    fn = _build.load("window_attention",
                     _D72_SIGNATURES).svt_window_attention
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), q.stride(2), k.stride(0), k.stride(2),
                 out.stride(0), out.stride(2), B, heads, H // k_win[0],
                 W // k_win[1], q.shape[2], *q_win, W, *k_win,
                 D72_KERNELS[kernel], 1.0 / math.sqrt(D72),
                 _build.stream_handle(q.device))
    _build.check(err, "window_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[kernel] += 1


def _windows(x: torch.Tensor, heads: int, wh: int, ww: int) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B * windows * heads, wh * ww, C / heads]``,
    windows in row-major order, the head innermost."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, heads, C // heads)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, wh * ww, C // heads)


def window_attention_plain(q, k, v, heads: int, window: int
                           ) -> torch.Tensor:
    """The plain version of ``window_attention``: the windows copied out,
    ``blocked_attention`` over each window and head, copied back."""
    B, Hq, Wq, C = q.shape
    (qh, qw), (kh, kw) = _window_sides(q, k, window)
    o = blocked_attention(_windows(q, heads, qh, qw),
                          _windows(k, heads, kh, kw),
                          _windows(v, heads, kh, kw))
    o = o.reshape(B, Hq // qh, Wq // qw, heads, qh, qw, C // heads)
    return o.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hq, Wq, C)


def _window_sides(q, k, window: int) -> tuple:
    """The query and key windows' (rows, columns): ``window`` square on
    the key grid (0: the whole grid), scaled to the query grid, which must
    hold as many windows."""
    (H, W), (Hq, Wq) = k.shape[1:3], q.shape[1:3]
    if window == 0:
        return (Hq, Wq), (H, W)
    if H % window or W % window or H % Hq or W % Wq or H // Hq != W // Wq \
            or window % (H // Hq):
        raise ValueError(f"window {window} does not tile the key grid "
                         f"{H}x{W} and the query grid {Hq}x{Wq} alike")
    wq = window // (H // Hq)
    return (wq, wq), (window, window)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, window: int) -> torch.Tensor:
    """Attention inside square windows of channels-last token grids, the
    attention of a Hiera block: ``q [B, Hq, Wq, C]``, ``k`` and ``v [B, H,
    W, C]``, ``heads`` heads of ``C / heads``; ``window`` is the side of a
    key window, 0 for one window over the whole grid (global attention).
    The query grid may be smaller by a factor (queries max-pooled inside
    their windows): its windows are smaller by the same factor. Returns
    ``[B, Hq, Wq, C]`` in q's dtype.

    CPU tensor: the plain version. CUDA tensor: the D = 72 kernels (bf16,
    ``C = 72 heads``), which read q, k and v in place (views of one qkv
    tensor, token stride ``3 C``, serve) and write the output grid."""
    if q.dim() != 4 or k.shape != v.shape or q.shape[::3] != k.shape[::3] \
            or q.shape[-1] % heads:
        raise ValueError(f"q, k, v must be [B, H, W, C] grids of one B and "
                         f"C, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q_win, k_win = _window_sides(q, k, window)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, heads, window)
    if q.shape[-1] != heads * D72:
        raise ValueError(f"the kernels take heads of {D72}, got "
                         f"{q.shape[-1] // heads}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_d72(q, k, v, out, heads, q_win, k_win,
                "bf16_d72" if window == 0 else "bf16_d72_window")
    return out


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
