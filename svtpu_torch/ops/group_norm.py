"""GroupNorm(32) with an optional SiLU over channels-last activations: the
hand-written CUDA kernel (``csrc/group_norm_silu.cu``) and its plain
PyTorch version.

The SD first stage's norm (``models/autoencoder_kl.py``, ``GroupNormSiLU``;
``svtpu/models/autoencoder_kl.py`` runs it as XLA ops, so no TPU kernel is
replaced): per frame and group of ``C / 32`` channels, the biased mean and
variance in float32, ``(x - mean) / sqrt(var + eps) * weight + bias``, then
SiLU, rounded once to the output dtype. Inference only: no gradient.

``group_norm_silu`` takes the plain version for a CPU tensor (any layout;
the output keeps the input's memory format) and the kernel for a CUDA
tensor, or raises; it counts its calls on the card in
``group_norm_silu.launches``. On the card it reads and writes NCHW
tensors in channels-last memory (``[B, H, W, C]`` underneath), the layout
the SD encoder's convs keep; an input in another layout is made
channels-last first (one copy).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from svtpu_torch.ops import _build

GROUPS = 32
# The kernel's block (csrc/group_norm_silu.cu, kThreads) and vector width.
_THREADS = 256
_VECTOR_BYTES = 16
# Pixel steps a block takes at most, and the blocks that fill the card:
# two rounds of 8 blocks of 256 threads an SM.
_MAX_STEPS = 16
_BLOCKS_PER_SM = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The widths the kernel takes: 32 groups of 1, 2, 4, 8 or 16 channels.
_CHANNELS = (32, 64, 128, 256, 512)
_SIGNATURES = {"svt_group_norm_silu": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
    ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])}


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float, silu: bool,
                          dtype) -> torch.Tensor:
    """The function in plain PyTorch, on any device: GroupNorm(32) and the
    optional SiLU in float32, then ``dtype``; keeps ``x``'s memory
    format."""
    h = F.group_norm(x.float(), GROUPS, weight, bias, eps)
    return (F.silu(h) if silu else h).to(dtype)


def tile_pixels(batch: int, hw: int, c: int, itemsize: int, sms: int) -> int:
    """Pixels a block of the kernel takes: whole steps of the pixels its
    256 threads cover at once (16 bytes each), up to 16 steps, fewer where
    that would leave fewer than ``_BLOCKS_PER_SM`` blocks an SM."""
    rows = _THREADS * _VECTOR_BYTES // (c * itemsize)
    steps = batch * hw // (rows * _BLOCKS_PER_SM * sms)
    return rows * max(1, min(_MAX_STEPS, steps))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype) -> None:
    if x.dtype not in _DTYPES or dtype != x.dtype:
        raise TypeError(f"group_norm_silu takes float32 or bfloat16 in and "
                        f"the same out, got {x.dtype} -> {dtype}")
    if x.dim() != 4 or x.shape[1] not in _CHANNELS:
        raise ValueError(f"group_norm_silu takes [B, C, H, W] with C in "
                         f"32, 64, 128, 256, 512, got {tuple(x.shape)}")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (x.shape[1],)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"group_norm_silu: {name} must be a contiguous "
                             f"float32 [{x.shape[1]}] on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("group_norm_silu has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float, silu: bool, dtype) -> torch.Tensor:
    """GroupNorm(32) of NCHW ``x`` with float32 ``weight`` and ``bias``,
    then SiLU if ``silu``, in ``dtype``.

    CPU tensor: the plain version. CUDA tensor: the kernel, or an
    exception — there is no fallback: float32 or bfloat16 with ``dtype``
    the same, C in 32, 64, 128, 256, 512, no gradient. The result is
    channels-last.
    """
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, eps, silu, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, weight, bias, dtype)
    x = _build.plain(x).contiguous(memory_format=torch.channels_last)
    # Held until the launch: a parameter's detached view shares its
    # storage; a temporary's address could be reused before the kernel
    # reads it.
    weight, bias = (_build.plain(p.detach()) for p in (weight, bias))
    B, C, H, W = x.shape
    out = torch.empty((B, H, W, C), dtype=x.dtype,
                      device=x.device).permute(0, 3, 1, 2)
    if x.data_ptr() % _VECTOR_BYTES:
        raise ValueError("group_norm_silu: the input is not 16-byte aligned")
    tile = tile_pixels(B, H * W, C, x.element_size(),
                       _sm_count(x.device.index))
    tiles = -(-(H * W) // tile)
    part = torch.empty((B, tiles, GROUPS, 2), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((B, GROUPS, 2), dtype=torch.float32, device=x.device)
    fn = _build.load("group_norm_silu", _SIGNATURES).svt_group_norm_silu
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), part.data_ptr(), stats.data_ptr(), B,
                 H * W, C, tile, _DTYPES[x.dtype], int(silu), float(eps),
                 _build.stream_handle(x.device))
    _build.check(err, "group_norm_silu")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
