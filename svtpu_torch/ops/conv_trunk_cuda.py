"""Fused conv0 → ReLU → conv1 → ReLU of the contrastive trunk: the
hand-written CUDA kernel (``csrc/fused_conv01.cu``) and its plain PyTorch
version.

Counterpart of ``svtpu/ops/conv_trunk_pallas.py::fused_conv01``:
``relu(conv1(relu(conv0(x))))``, both convs k3/s2/p1 with bias, on
``x [B, 256, 256, 3]`` NHWC (f32 or bf16) → ``[B, 64, 64, 64]`` NHWC in the
input dtype. Weights come in torch's ``Conv2d`` layout (``[64, 3, 3, 3]``,
``[64, 64, 3, 3]``), float32, as the model holds them. Rounding is that of
the TPU path: in bf16, conv0's output plus bias is rounded to bf16 before
its ReLU, and conv1 accumulates in f32, adds an f32 bias and rounds once.
Inference only: no gradient.

``fused_conv01`` takes the plain version for a CPU tensor and the kernel for
a CUDA tensor; it counts its kernel launches in ``fused_conv01.launches``.
bf16 runs the tensor-core kernel, which reads the weights in the GEMM
layouts of ``pack_w0`` and ``pack_w1``; f32 runs the CUDA-core kernel on
HWIO weights.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from svtpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPES = {"w0": (64, 3, 3, 3), "b0": (64,), "w1": (64, 64, 3, 3),
           "b1": (64,)}
_SIGNATURES = {"svt_fused_conv01": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])}


def fused_conv01_plain(x, w0, b0, w1, b1) -> torch.Tensor:
    """The kernel's function and rounding in plain PyTorch, on any device.

    Products of values already rounded to the input dtype are summed in
    float32 (exact products, f32 sums), as the kernel does; on a card this
    needs ``torch.backends.cudnn.allow_tf32 = False`` to be float32.
    """
    dt = x.dtype
    h = F.conv2d(x.permute(0, 3, 1, 2).float(), w0.to(dt).float(), None, 2, 1)
    h = (h.to(dt) + b0.to(dt).view(1, -1, 1, 1)).relu()
    h = F.conv2d(h.float(), w1.to(dt).float(), None, 2, 1)
    h = (h + b1.float().view(1, -1, 1, 1)).relu().to(dt)
    return h.permute(0, 2, 3, 1).contiguous()


def pack_w0(w0: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """conv0's weights ``[64, 3, 3, 3]`` (OIHW) as the tensor-core kernel
    reads them: ``[64, 32]``, row ``co`` holding ``k = (ky * 3 + kx) * 3 +
    ci`` for ``k < 27`` and zeros up to the GEMM depth of 32."""
    w = w0.to(dtype).permute(0, 2, 3, 1).reshape(64, 27)
    return F.pad(w, (0, 32 - 27)).contiguous()


def unpack_w0(packed: torch.Tensor) -> torch.Tensor:
    """``pack_w0``'s inverse: back to ``[64, 3, 3, 3]`` OIHW."""
    return packed[:, :27].reshape(64, 3, 3, 3).permute(0, 3, 1, 2)


def _w1_chunks(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ``co`` and the stored position of logical 16-byte chunk ``c``
    (8 bf16 values) of that row: ``c ^ (co % 8)``."""
    co = torch.arange(64, device=device)[:, None]
    c = torch.arange(72, device=device)[None, :]
    return co, c ^ (co % 8)


def pack_w1(w1: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """conv1's weights ``[64, 64, 3, 3]`` (OIHW) as the tensor-core kernel
    keeps them in shared memory: ``[64, 576]``, row ``co`` holding the GEMM
    depth ``k = (ky * 3 + kx) * 64 + ci`` in chunks of 8 values, chunk ``c``
    stored at ``c ^ (co % 8)`` so that ldmatrix's 8 rows hit 8 bank
    groups."""
    w = w1.to(dtype).permute(0, 2, 3, 1).reshape(64, 72, 8)
    co, pos = _w1_chunks(w.device)
    out = torch.empty_like(w)
    out[co, pos] = w
    return out.reshape(64, 576)


def unpack_w1(packed: torch.Tensor) -> torch.Tensor:
    """``pack_w1``'s inverse: back to ``[64, 64, 3, 3]`` OIHW."""
    co, pos = _w1_chunks(packed.device)
    w = packed.reshape(64, 72, 8)[co, pos]
    return w.reshape(64, 3, 3, 64).permute(0, 3, 1, 2)


def kernel_weights(dt, w0, b0, w1, b1) -> tuple:
    """``(w0, b0, w1, b1)`` as the kernel for ``dt`` reads them: bf16 in
    the tensor-core GEMM layouts (``pack_w0``, ``pack_w1``), f32 in HWIO
    (each (tap, input channel) row holds the 64 output channels); ``b1``
    in f32. The wrapper packs on every call.

    Inside a CUDA graph of the encode (``models/encode_graph.py``) the
    packing is captured as device work that reads the parameters where
    they lie, so every replay packs the current weights: the trainer's
    probes replay between Adam's in-place updates. A cache of packed
    weights would leave a replay reading stale ones; keep none.
    ``_w1_chunks``' index tensors are made on the device, in the graph's
    pool, which a capture allows."""
    if dt == torch.bfloat16:
        w0k, w1k = pack_w0(w0), pack_w1(w1)
    else:
        w0k = w0.to(dt).permute(2, 3, 1, 0).contiguous()
        w1k = w1.to(dt).permute(2, 3, 1, 0).contiguous()
    return w0k, b0.to(dt).contiguous(), w1k, b1.float().contiguous()


def _check(x, params: dict) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (256, 256, 3):
        raise ValueError(f"x must be [B, 256, 256, 3], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in params.items():
        if tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"{name} must be {_SHAPES[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_conv01(x, w0, b0, w1, b1) -> torch.Tensor:
    """``relu(conv1(relu(conv0(x))))`` in one kernel on the card.

    CPU tensor: the plain version. CUDA tensor: the kernel, or an
    exception — there is no fallback.
    """
    _check(x, {"w0": w0, "b0": b0, "w1": w1, "b1": b1})
    if x.device.type == "cpu":
        return fused_conv01_plain(x, w0, b0, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = _build.plain(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if x.data_ptr() % 16:
        x = x.clone()             # the kernels copy 16-byte pieces
    dt = x.dtype
    w0k, b0k, w1k, b1k = kernel_weights(dt, w0, b0, w1, b1)
    B = x.shape[0]
    out = torch.empty((B, 64, 64, 64), dtype=dt, device=x.device)
    if B == 0:
        return out
    fn = _build.load("fused_conv01", _SIGNATURES).svt_fused_conv01
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w0k.data_ptr(), b0k.data_ptr(), w1k.data_ptr(),
                 b1k.data_ptr(), out.data_ptr(), B, _DTYPES[dt],
                 _build.stream_handle(x.device))
    _build.check(err, "fused_conv01")
    fused_conv01.launches += 1
    return out


fused_conv01.launches = 0
