"""Fused Binary-Concrete sampler: the hand-written CUDA kernel
(``csrc/binary_concrete.cu``) and its plain PyTorch version.

Counterpart of ``svtpu/ops/binarize_pallas.py::binary_concrete_pallas``:
per element, a 24-bit uniform ``u``, logistic noise
``log(u+eps) - log(1-u+eps)``, ``y = sigmoid((x + scale*noise)/T)`` and, if
``hard``, ``y > 0.5`` — in float32, stored in the logits' dtype. The random
bits are Philox4x32-10 keyed by ``seed`` with the element index as the
counter (four elements per draw). The plain version computes the very same
bits with integer tensor arithmetic, so kernel and plain version agree
element for element, not just in distribution. Inference only: no gradient.

``binary_concrete_fused`` takes the plain version for a CPU tensor and the
kernel for a CUDA tensor; it counts its kernel launches in
``binary_concrete_fused.launches``. The seed is a Python int or a
one-element int64 tensor on the logits' device, which the kernel reads
where it lies: a seed drawn on the card never makes the host wait for it.
Only the plain version reads a seed tensor's value on the host. The
temperature and the noise scale are each a Python number or a 0-dim
float32 tensor on the logits' device, which the kernel reads where it lies:
a CUDA graph of the encode bakes a number in, and reads a tensor that the
caller writes before each replay. Both give the kernel the same float32
(``float(v)`` rounded to float32 by ctypes, or the tensor made from it).
"""
from __future__ import annotations

import ctypes

import torch

from svtpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {"svt_binary_concrete": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])}
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` for uint32 values held in
    int64, without overflowing int64 (16-bit limbs)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    low = a_lo * m_lo + ((a_hi * m_lo + a_lo * m_hi) << 16)
    lo = low & _MASK
    hi = (a_hi * m_hi + (low >> 32)) & _MASK
    return hi, lo


def philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 (Random123) of counters ``(counter, 0, 0, 0)`` under the
    64-bit key ``seed``. ``counter``: int64 ``[G]`` → int64 ``[G, 4]`` holding
    the four uint32 output words, as the kernel produces them."""
    c0, c1 = counter & _MASK, (counter >> 32) & _MASK
    c2, c3 = torch.zeros_like(c0), torch.zeros_like(c0)
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_uniform(n: int, seed: int, device=None) -> torch.Tensor:
    """The kernel's ``u`` for elements ``0..n-1``: float32 in [0, 1)."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    bits = philox4x32_10(groups, seed).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _f32(v, device) -> torch.Tensor:
    """A number or a 0-dim tensor as the float32 the kernel computes with."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32)


def binary_concrete_fused_plain(logits: torch.Tensor, seed,
                                temperature=0.5, noise_scale=1.0,
                                hard: bool = True, eps: float = 1e-8,
                                noisy: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device. ``seed``:
    an int or a one-element tensor, whose value it reads on the host;
    ``temperature``, ``noise_scale``: numbers or 0-dim tensors."""
    x = logits.to(torch.float32)
    if noisy:
        u = philox_uniform(x.numel(), int(seed), x.device).reshape(x.shape)
        noise = torch.log(u + eps) - torch.log(1.0 - u + eps)
        x = x + _f32(noise_scale, x.device) * noise
    y = torch.sigmoid(x / _f32(temperature, x.device))
    if hard:
        y = (y > 0.5).to(torch.float32)
    return y.to(logits.dtype)


def check_seed(seed):
    """A seed for the sampler kernels: an int in ``[0, 2**64)``, returned as
    an int, or a one-element int64 tensor, returned untouched. A tensor's
    value is never read here: on the card that would make the host wait
    for the work that draws it."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"a seed tensor must hold one int64, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        return seed
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64): {seed}")
    return seed


def seed_args(seed, device) -> tuple:
    """The launchers' ``(seed_ptr, seed)`` pair: a seed tensor (which must
    lie on ``device``) by its address, an int by value."""
    if isinstance(seed, torch.Tensor):
        if seed.device != device:
            raise ValueError(f"the seed is on {seed.device}, the logits on "
                             f"{device}")
        return seed.data_ptr(), 0
    return None, seed


def scalar_args(value, device, what: str) -> tuple:
    """The launchers' ``(ptr, value)`` pair for the temperature or the
    noise scale: a 0-dim float32 tensor on ``device`` by its address (its
    value is never read here), a number by value."""
    if isinstance(value, torch.Tensor):
        if (value.dtype != torch.float32 or value.dim() != 0
                or value.device != device):
            raise ValueError(f"the {what} tensor must be a 0-dim float32 on "
                             f"{device}, got {value.dtype} "
                             f"{tuple(value.shape)} on {value.device}")
        return _build.plain(value).data_ptr(), 0.0
    return None, float(value)


def binary_concrete_fused(logits: torch.Tensor, seed,
                          temperature=0.5, noise_scale=1.0,
                          hard: bool = True, eps: float = 1e-8,
                          noisy: bool = True) -> torch.Tensor:
    """Sample Binary-Concrete values for logits of any shape in one pass.

    CPU tensor: the plain version. CUDA tensor: the kernel, or an
    exception — there is no fallback. ``seed``: an int, or a one-element
    int64 tensor on the logits' device (see ``check_seed``).
    ``temperature``, ``noise_scale``: numbers, or 0-dim float32 tensors on
    the logits' device (see ``scalar_args``).
    """
    seed = check_seed(seed)
    if logits.device.type == "cpu":
        return binary_concrete_fused_plain(logits, seed, temperature,
                                           noise_scale, hard, eps, noisy)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {logits.dtype}")
    seed_ptr, seed_val = seed_args(seed, logits.device)
    temp_ptr, temp_val = scalar_args(temperature, logits.device,
                                     "temperature")
    scale_ptr, scale_val = scalar_args(noise_scale, logits.device,
                                       "noise scale")
    x = _build.plain(logits).contiguous()
    out = torch.empty_like(x)
    fn = _build.load("binary_concrete", _SIGNATURES).svt_binary_concrete
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
                 seed_ptr, seed_val, temp_ptr, temp_val, scale_ptr,
                 scale_val, float(eps), int(hard), int(noisy),
                 _build.stream_handle(x.device))
    _build.check(err, "binary_concrete")
    binary_concrete_fused.launches += 1
    return out


binary_concrete_fused.launches = 0
