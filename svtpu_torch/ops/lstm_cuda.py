"""The RBVAE encoder's LSTM with the Binary-Concrete sampler fused into its
last layer: the hand-written CUDA kernel (``csrc/lstm_binary_concrete.cu``)
and its plain PyTorch version.

On the post-RNN encode route (contrastive, triplet, percep) the encoder LSTM
(``ops/lstm.py``, the port of ``svtpu/ops/lstm.py:45-85``) feeds the
sampler (``ops/binarize_cuda.py``, the port of
``svtpu/ops/binarize_pallas.py``). The kernel runs both in one launch: all
layers, the residual path when the LSTM has one, then the sampler on the
last layer's ``[B, T, H]`` output with the standalone kernel's Philox key
and counter, so that for a given ``h`` the codes are bit for bit the
standalone sampler's. The plain version is those two plain calls.

Shapes it takes: ``LSTM(H, H)`` (every RBVAE LSTM is ``LSTM(L, L)``) with
``H <= 64`` and at most 8 layers, any batch, ``T >= 1``, compute dtype
float32 or bfloat16, float32 parameters. The wrapper raises on anything
else, on every device; ``takes`` says beforehand whether an LSTM fits.
Wider latents (the sweeps search 50 to 100) do not fit: at H = 100 one
layer's f32 weights alone need ~320 KB of shared memory. Inference only: no
gradient.

``lstm_binary_concrete`` takes the plain version for a CPU tensor and the
kernel for a CUDA tensor; it counts its kernel launches in
``lstm_binary_concrete.launches``. Its seed is an int or a one-element int64
tensor on the input's device, and its temperature and noise scale numbers
or 0-dim float32 tensors there (``binarize_cuda.scalar_args``); the kernel
reads each tensor where it lies, so one CUDA graph of the encode serves
every temperature.
"""
from __future__ import annotations

import ctypes

import torch

from svtpu_torch.ops import _build
from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused_plain,
                                           check_seed, scalar_args, seed_args)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 64
MAX_LAYERS = 8
_SIGNATURES = {"svt_lstm_binary_concrete": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}


def layer_params(lstm, k: int) -> tuple:
    """Layer ``k``'s ``(w_ih [4H, H], w_hh [4H, H], b_ih [4H], b_hh [4H])``
    as ``nn.LSTM`` holds them."""
    m = lstm.lstm
    return tuple(getattr(m, f"{name}_l{k}") for name in
                 ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


def lstm_binary_concrete_plain(lstm, x: torch.Tensor, seed,
                               temperature=0.5, noise_scale=1.0,
                               hard: bool = True, eps: float = 1e-8,
                               noisy: bool = True):
    """The kernel's function in plain PyTorch, on any device: ``lstm(x)``,
    then ``binary_concrete_fused_plain`` on its output. Returns ``(codes,
    h)``."""
    h = lstm(x)
    return binary_concrete_fused_plain(h, seed, temperature, noise_scale,
                                       hard, eps, noisy), h


def _unsupported(lstm):
    """Why the kernel does not take ``lstm``, or ``None`` when it does."""
    H = lstm.hidden_size
    if lstm.lstm.input_size != H:
        return (f"the fused kernel takes LSTM(H, H), got input size "
                f"{lstm.lstm.input_size} and hidden size {H}")
    if H > MAX_HIDDEN:
        return f"hidden size {H} > {MAX_HIDDEN}"
    if not 1 <= lstm.num_layers <= MAX_LAYERS:
        return f"{lstm.num_layers} layers: 1 to {MAX_LAYERS} are supported"
    if lstm.dtype not in _DTYPES:
        return f"unsupported compute dtype {lstm.dtype}"
    return None


def takes(lstm) -> bool:
    """Whether the kernel takes ``lstm``'s shape and dtype: a caller picks
    its route with this (a wider LSTM runs as plain ops, then the
    standalone sampler)."""
    return _unsupported(lstm) is None


def _check(lstm, x: torch.Tensor) -> list:
    """Raise on what the kernel does not take; return each layer's
    ``layer_params``."""
    why = _unsupported(lstm)
    if why is not None:
        raise ValueError(why)
    H = lstm.hidden_size
    if x.dim() != 3 or x.shape[-1] != H or x.shape[1] < 1:
        raise ValueError(f"x must be [B, T >= 1, {H}], got {tuple(x.shape)}")
    params = [layer_params(lstm, k) for k in range(lstm.num_layers)]
    for p in (p for layer in params for p in layer):
        if (p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"LSTM parameters must be contiguous float32 "
                             f"on {x.device}, got {p.dtype} on {p.device}")
    return params


def lstm_binary_concrete(lstm, x: torch.Tensor, seed, temperature=0.5,
                         noise_scale=1.0, hard: bool = True,
                         eps: float = 1e-8, noisy: bool = True,
                         return_h: bool = False):
    """Binary-Concrete codes of ``lstm(x)`` for ``x [B, T, H]``, in
    ``lstm.dtype``; with ``return_h``, ``(codes, h)``.

    ``lstm``: an ``ops.lstm.LSTM``. CPU tensor: the plain version. CUDA
    tensor: the kernel, or an exception — there is no fallback.
    """
    params = _check(lstm, x)
    seed = check_seed(seed)
    if x.device.type == "cpu":
        codes, h = lstm_binary_concrete_plain(lstm, x, seed, temperature,
                                              noise_scale, hard, eps, noisy)
        return (codes, h) if return_h else codes
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    seed_ptr, seed_val = seed_args(seed, x.device)
    temp_ptr, temp_val = scalar_args(temperature, x.device, "temperature")
    scale_ptr, scale_val = scalar_args(noise_scale, x.device, "noise scale")
    xk = _build.plain(x.to(lstm.dtype)).contiguous()
    B, T, H = xk.shape
    L = lstm.num_layers
    codes = torch.empty_like(xk)
    seq = torch.empty_like(xk) if (L > 1 or return_h) else None
    if B > 0:
        ptrs = [(ctypes.c_void_p * L)(*[p[i].data_ptr() for p in params])
                for i in range(4)]
        fn = _build.load("lstm_binary_concrete",
                         _SIGNATURES).svt_lstm_binary_concrete
        with torch.cuda.device(xk.device):
            err = fn(*ptrs, L, H, xk.data_ptr(),
                     None if seq is None else seq.data_ptr(),
                     codes.data_ptr(), seed_ptr, seed_val, B, T,
                     _DTYPES[lstm.dtype], int(lstm.residual), int(return_h),
                     temp_ptr, temp_val, scale_ptr, scale_val, float(eps),
                     int(hard), int(noisy), _build.stream_handle(xk.device))
        _build.check(err, "lstm_binary_concrete")
        lstm_binary_concrete.launches += 1
    return (codes, seq) if return_h else codes


lstm_binary_concrete.launches = 0
