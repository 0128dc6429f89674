"""Torch-geometry conv, transposed conv and dense layers with an explicit
compute dtype, and the three alternative conv routes of ``svtpu``
(``svtpu/ops/conv.py``).

These are XLA ops in the JAX package, so here they stay library calls
(``F.conv2d``, ``F.conv_transpose2d``, ``torch.matmul``, ``torch._int_mm``).
Parameters are held in torch's layouts (``Conv2d [O, I, kh, kw]``,
``ConvTranspose2d [I, O, kh, kw]``, ``Linear [out, in]``) with torch's
default init, so a reference state dict loads as it is. Activations inside
the model are NCHW (channels-last memory where they come from an NHWC
tensor).

The compute dtype is applied where the reference applies it: inputs and
weights are cast to it, the product is rounded to it, and the bias is added
in it afterwards.

The alternative routes compute the same layer from the same parameters:

  * ``conv_s2d_k3s2p1``: a k3/s2/p1 conv as a k2/s1 conv over 2x2
    space-to-depth blocks (exact up to summation order);
  * ``deconv_d2s_k3s2p1``: a k3/s2/p1/op1 transposed conv as one k2/s1
    conv to four phases and a 2x2 depth-to-space (likewise);
  * ``conv2d_int8``: dynamic symmetric int8 quantisation (inference only),
    int32 accumulation, dequantised in the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Largest unfolded int8 im2col buffer of one conv2d_int8 chunk on the card.
_INT8_CHUNK_BYTES = 256 * 1024 ** 2


def _s2d_applies(x: torch.Tensor, w: torch.Tensor, stride: int,
                 padding: int) -> bool:
    """``svtpu``'s rule: the s2d rewrite takes k3/s2/p1 with even H, W."""
    return ((w.shape[-1], stride, padding) == (3, 2, 1)
            and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)


def conv2d_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int, padding: int, dtype,
                 s2d: bool = False) -> torch.Tensor:
    """``nn.Conv2d(k, s, p)`` on NCHW ``x`` in ``dtype``; ``s2d`` computes
    it by ``conv_s2d_k3s2p1`` where that applies (k3/s2/p1, even H and W),
    else by the direct conv."""
    if s2d and _s2d_applies(x, w, stride, padding):
        y = conv_s2d_k3s2p1(x.to(dtype), w.to(dtype))
    else:
        y = F.conv2d(x.to(dtype), w.to(dtype), None, stride, padding)
    return y + b.to(dtype).view(1, -1, 1, 1)


def conv_s2d_k3s2p1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k3/s2/p1 conv of NCHW ``x`` (even H, W) as a k2/s1 conv over 2x2
    space-to-depth blocks (``svtpu/ops/conv.py:123-148``).

    Output row ``o`` reads padded rows ``2o..2o+2``; zero-padding the
    kernel to k4 extends that to ``2o..2o+3``, which are block rows ``o``
    and ``o+1`` of the padded input cut into 2x2 blocks. Block channels are
    ordered (row in block, column in block, input channel)."""
    B, C, H, W = x.shape
    O = w.shape[0]
    hb, wb = (H + 2) // 2, (W + 2) // 2
    xb = (F.pad(x, (1, 1, 1, 1)).reshape(B, C, hb, 2, wb, 2)
          .permute(0, 3, 5, 1, 2, 4).reshape(B, 4 * C, hb, wb))
    w2 = (F.pad(w, (0, 1, 0, 1)).reshape(O, C, 2, 2, 2, 2)
          .permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, 2, 2))
    return F.conv2d(xb, w2)


def conv_transpose2d_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           stride: int, padding: int, output_padding: int,
                           dtype, d2s: bool = False) -> torch.Tensor:
    """``nn.ConvTranspose2d(k, s, p, output_padding)`` on NCHW ``x``;
    ``d2s`` computes it by ``deconv_d2s_k3s2p1`` where that applies
    (k3/s2/p1/op1), else by the direct transposed conv."""
    if d2s and (w.shape[-1], stride, padding, output_padding) == (3, 2, 1, 1):
        y = deconv_d2s_k3s2p1(x.to(dtype), w.to(dtype))
    else:
        y = F.conv_transpose2d(x.to(dtype), w.to(dtype), None, stride,
                               padding, output_padding)
    return y + b.to(dtype).view(1, -1, 1, 1)


# Per output phase p (0 even, 1 odd) and tap j of the k2 sub-kernel, the
# transposed conv's kernel index (3: the zero pad): y[2a] = x[a] w[1],
# y[2a+1] = x[a] w[2] + x[a+1] w[0].
_D2S_TAPS = ((1, 3), (2, 0))


def deconv_d2s_k3s2p1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k3/s2/p1/op1 transposed conv of NCHW ``x`` (``w`` in
    ``ConvTranspose2d``'s ``[I, O, 3, 3]``) as one k2/s1 conv to ``4·O``
    channels, then a 2x2 depth-to-space (``svtpu/ops/conv.py:187-211``):
    each output phase is a k2 sub-kernel over the undilated input, so no
    product with a dilation zero is computed."""
    B, C, H, W = x.shape
    O = w.shape[1]
    wp = F.pad(w, (0, 1, 0, 1))                          # [I, O, 4, 4]
    # The taps by slices: an index tensor would be copied up from the host
    # at every call, which a CUDA graph of a train step cannot hold.
    taps = [slice(i, i + 1) for phase in _D2S_TAPS for i in phase]
    w2 = torch.cat([wp[:, :, t] for t in taps], 2)
    w2 = torch.cat([w2[:, :, :, t] for t in taps], 3)   # [I, O, 4, 4]
    w2 = (w2.reshape(C, O, 2, 2, 2, 2)                  # [I, O, py, jy, px, jx]
          .permute(2, 4, 1, 0, 3, 5).reshape(4 * O, C, 2, 2))
    y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w2)             # [B, 4·O, H, W]
    return (y.reshape(B, 2, 2, O, H, W).permute(0, 3, 4, 1, 5, 2)
            .reshape(B, O, 2 * H, 2 * W))


def int8_quantize(x: torch.Tensor, w: torch.Tensor):
    """``conv2d_int8``'s quantisation: per-output-channel kernel scales
    (``max|w|`` over I, kh, kw, /127) and one activation scale for the
    whole tensor (``max|x|``, /127, in f32), each at least 1e-8; values
    divided by their scale, rounded half to even and clipped to ±127.
    Returns ``(xq, kq, ascale, kscale)``, the first two int8; ``xq`` keeps
    ``x``'s memory format."""
    kscale = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-8)
    kq = torch.clamp(torch.round(w / kscale.view(-1, 1, 1, 1)),
                     -127, 127).to(torch.int8)
    ascale = torch.clamp(x.abs().amax().float() / 127.0, min=1e-8)
    xq = x.float().div_(ascale).round_().clamp_(-127, 127).to(torch.int8)
    return xq, kq, ascale, kscale


def int8_conv_accumulate_plain(xq: torch.Tensor, kq: torch.Tensor,
                               stride: int, padding: int) -> torch.Tensor:
    """The int32 accumulators of an int8 conv, as an f32 ``F.conv2d`` of
    the integer-valued tensors: exact where every partial sum is an integer
    below 2^24 (fan-in 576 · 127² < 2^24), with TF32 off on the card. A
    wider fan-in (the simple variant's 2,048) accumulates in f64."""
    dt = torch.float32 if kq[0].numel() * 127 * 127 < 2 ** 24 \
        else torch.float64
    return F.conv2d(xq.to(dt), kq.to(dt), None, stride, padding) \
        .to(torch.int32)


def _int8_conv_gemm(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """The int32 accumulators on the card: im2col of the int8 activations
    in NHWC order (strided views, one copy that moves whole channel runs),
    then int8 x int8 → int32 GEMMs on the tensor cores
    (``torch._int_mm``, cuBLASLt) against the kernel in (kh, kw, I) order,
    in chunks of frames that keep the unfolded buffer under
    ``_INT8_CHUNK_BYTES``. Returns NCHW in channels-last memory."""
    B, C, H, W = xq.shape
    O, _, kh, kw = kq.shape
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    K = C * kh * kw
    if K % 8 or O % 8:
        raise ValueError(f"int8 GEMM needs fan-in and outputs in multiples "
                         f"of 8: {K}, {O}")
    wmat = kq.permute(0, 2, 3, 1).reshape(O, K).t()      # [K, O], col-major
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0) + (padding,) * 4)  # NHWC
    step = max(1, _INT8_CHUNK_BYTES // (Ho * Wo * K))
    out = torch.empty(B, Ho, Wo, O, dtype=torch.int32, device=xq.device)
    for i in range(0, B, step):
        cols = (xp[i:i + step].unfold(1, kh, stride).unfold(2, kw, stride)
                .permute(0, 1, 2, 4, 5, 3).reshape(-1, K))
        out[i:i + step] = torch._int_mm(cols, wmat).view(-1, Ho, Wo, O)
    return out.permute(0, 3, 1, 2)


def int8_conv_accumulate(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                         padding: int) -> torch.Tensor:
    """The int32 accumulators ``[B, O, Ho, Wo]`` of an int8 conv: the
    tensor-core GEMM on a CUDA tensor, the plain version on a CPU one."""
    if xq.device.type == "cpu":
        return int8_conv_accumulate_plain(xq, kq, stride, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv: no route on {xq.device}")
    int8_conv_accumulate.launches += 1
    return _int8_conv_gemm(xq, kq, stride, padding)


int8_conv_accumulate.launches = 0


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int, padding: int, dtype) -> torch.Tensor:
    """Dynamic symmetric int8 conv of NCHW ``x`` (inference only;
    ``svtpu/ops/conv.py:50-71``): ``int8_quantize``, int32 accumulation,
    then ``(acc · (ascale · kscale))`` rounded to ``dtype`` plus the bias
    in ``dtype``. The activation scale spans the whole batch, so a batch's
    codes depend on its other frames."""
    xq, kq, ascale, kscale = int8_quantize(x, w)
    acc = int8_conv_accumulate(xq, kq, stride, padding)
    y = acc.float() * (ascale * kscale).view(1, -1, 1, 1)
    return y.to(dtype) + b.to(dtype).view(1, -1, 1, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dtype) -> torch.Tensor:
    """``x @ w.T + b`` in ``dtype`` (``w`` in ``nn.Linear``'s layout)."""
    return x.to(dtype) @ w.to(dtype).T + b.to(dtype)


class Conv2dTorch(nn.Conv2d):
    """``nn.Conv2d`` whose forward runs in a given compute dtype (``s2d``:
    through ``conv_s2d_k3s2p1`` where it applies)."""

    def forward(self, x: torch.Tensor, dtype=torch.float32,
                s2d: bool = False) -> torch.Tensor:
        return conv2d_torch(x, self.weight, self.bias, self.stride[0],
                            self.padding[0], dtype, s2d)


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose forward runs in a given compute dtype
    (``d2s``: through ``deconv_d2s_k3s2p1`` where it applies)."""

    def forward(self, x: torch.Tensor, dtype=torch.float32,
                d2s: bool = False) -> torch.Tensor:
        return conv_transpose2d_torch(x, self.weight, self.bias,
                                      self.stride[0], self.padding[0],
                                      self.output_padding[0], dtype, d2s)


class Dense(nn.Linear):
    """``nn.Linear`` whose forward runs in a given compute dtype. Pass
    ``dtype`` by keyword: under ``parallelize_rbvae`` the tensor-parallel
    style's input hook keeps the first positional argument only, and a
    positional dtype fell back to float32."""

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return dense(x, self.weight, self.bias, dtype)
