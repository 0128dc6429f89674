"""The plain reference of V-JEPA 2's video encoder (ViT-L/16 over 64-frame
clips at 256x256; ``facebook/vjepa2-vitl-fpc64-256``, "V-JEPA 2:
Self-Supervised Video Models Enable Understanding, Prediction and
Planning"), as the clip path uses it: the preprocessing, the encoder to
its final norm, and the percep RBVAE's encode of the features
(``reference/rbvae.py``).

Plain PyTorch in float32 with TF32 off, from the published equations:

  * preprocessing (``video_processing_vjepa2.py``): the shorter side
    resized to ``int(crop * 256 / 224)``, the longer one scaled and
    rounded down (bilinear, antialiased), the centre ``crop`` square,
    divided by 255, normalised by ImageNet's mean and deviation;
  * the tubelet embed: ``Conv3d(3, hidden, kernel = stride = (tubelet,
    patch, patch))``, its output flattened to tokens in (t, h, w) order;
  * pre-LN blocks: ``x += proj(attn(LN1 x))``, ``x += fc2(GELU(fc1(LN2
    x)))``, GELU by erf, LayerNorm eps 1e-6; q, k, v linear with bias,
    heads of ``hidden / heads``, non-causal softmax attention scaled by
    ``head_dim^-0.5``;
  * the 3-D rotary embedding on q and k as ``rotate_queries_or_keys``
    computes it, recomputed at every call in the operands' dtype: blocks of
    ``2 * ((head_dim // 3) // 2)`` dims rotated by the frame, row and
    column index, angles ``10000^(-i / m)`` tiled (not interleaved) over
    each block, the tail unrotated;
  * the final LayerNorm.

Departures: attention is computed in blocks of ``ATTN_ROWS`` queries, so
that 8,192 tokens fit; clips are encoded one at a time; the last clip of a
batch is padded by repeating its last frame (the clip path's grouping, not
the model's). It imports nothing of the program. ``low=True`` is the
control, as in ``reference/rbvae.py``: every product (the embed, the
linears, q kᵀ and p v) from fp8 e4m3 operands, the rest in bfloat16.

Parameters are a dict in the published state-dict names, float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.rbvae import _dt, _q

ATTN_ROWS = 1024        # query rows a block of the reference's attention


def param_shapes(cfg: dict) -> dict:
    """Every parameter of the encoder, by state-dict name → shape."""
    C, t, p = cfg["hidden_size"], cfg["tubelet_size"], cfg["patch_size"]
    M = int(C * cfg["mlp_ratio"])
    e = "encoder.embeddings.patch_embeddings.proj"
    out = {f"{e}.weight": (C, cfg["in_chans"], t, p, p), f"{e}.bias": (C,)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}"
        for name, (o, n) in (("attention.query", (C, C)),
                             ("attention.key", (C, C)),
                             ("attention.value", (C, C)),
                             ("attention.proj", (C, C)),
                             ("mlp.fc1", (M, C)), ("mlp.fc2", (C, M))):
            out[f"{pre}.{name}.weight"] = (o, n)
            out[f"{pre}.{name}.bias"] = (o,)
        for norm in ("norm1", "norm2"):
            out[f"{pre}.{norm}.weight"] = (C,)
            out[f"{pre}.{norm}.bias"] = (C,)
    out["encoder.layernorm.weight"] = (C,)
    out["encoder.layernorm.bias"] = (C,)
    return out


def init_weights(cfg: dict, seed: int, device, gains: dict | None = None
                 ) -> dict:
    """Seeded weights on ``device`` at the published init, drawn by a
    generator there in one call: every product's weight from a normal of
    std 0.02 (``trunc_normal_``'s cut at +-2, which at that std cuts
    nothing), biases zero, LayerNorm ones and zeros. ``gains``: a factor
    for the weights whose names hold a key."""
    gains = gains or {}
    shapes = param_shapes(cfg)
    weights = [k for k, s in shapes.items()
               if k.endswith(".weight") and len(s) > 1]
    sizes = [int(np.prod(shapes[k])) for k in weights]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, std=0.02, generator=gen)
    out, at = {}, 0
    for name, n in zip(weights, sizes):
        w = flat[at:at + n].view(shapes[name])
        at += n
        for key, g in gains.items():
            if key in name:
                w = w * g
        out[name] = w.contiguous()
    for name, shape in shapes.items():
        if name not in out:
            ones = len(shape) == 1 and "norm" in name \
                and name.endswith(".weight")
            out[name] = (torch.ones if ones else torch.zeros)(
                shape, device=device)
    return out


def tokens(cfg: dict) -> int:
    """Tokens of one clip: ``T' * h * w``."""
    g = cfg["crop_size"] // cfg["patch_size"]
    return cfg["frames_per_clip"] // cfg["tubelet_size"] * g * g


def resized_hw(hw, short: int) -> tuple[int, int]:
    h, w = hw
    return (short, int(short * w / h)) if h <= w \
        else (int(short * h / w), short)


def preprocess(cfg: dict, frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` → float32 ``[N, 3, crop, crop]``."""
    short = int(cfg["crop_size"] * 256 / 224)
    h, w = resized_hw(frames_u8.shape[1:3], short)
    x = frames_u8.float().permute(0, 3, 1, 2)
    if (h, w) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    c = cfg["crop_size"]
    top, left = (h - c) // 2, (w - c) // 2
    x = x[:, :, top:top + c, left:left + c] / 255.0
    mean = torch.tensor(cfg["image_mean"], device=x.device)[:, None, None]
    std = torch.tensor(cfg["image_std"], device=x.device)[:, None, None]
    return (x - mean) / std


def clips(cfg: dict, frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames → the preprocessed clips ``[B, T, 3, crop, crop]``, the
    last padded by repeating its last frame."""
    x = preprocess(cfg, frames_u8)
    per = cfg["frames_per_clip"]
    pad = -len(x) % per
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x.reshape(-1, per, *x.shape[1:])


def rotate_queries_or_keys(x: torch.Tensor, pos: torch.Tensor
                           ) -> torch.Tensor:
    """The published rotation of ``x [B, heads, N, D]`` by ``pos [N]``."""
    D = x.shape[-1]
    omega = torch.arange(D // 2, dtype=x.dtype, device=x.device)
    omega /= D / 2.0
    omega = 1.0 / 10000 ** omega
    freq = pos.unsqueeze(-1) * omega
    emb_sin = freq.sin().repeat(1, 1, 1, 2)
    emb_cos = freq.cos().repeat(1, 1, 1, 2)
    y1, y2 = x.unflatten(-1, (-1, 2)).unbind(dim=-1)
    y = torch.stack((-y2, y1), dim=-1).flatten(-2)
    return x * emb_cos + y * emb_sin


def rope(cfg: dict, qk: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_embeddings`` of ``qk [B, heads, N, D]``."""
    D = qk.shape[-1]
    g = cfg["crop_size"] // cfg["patch_size"]
    ids = torch.arange(qk.shape[2], device=qk.device)
    t = ids // (g * g)
    h = (ids - g * g * t) // g
    w = ids - g * g * t - g * h
    block = 2 * ((D // 3) // 2)
    parts = [rotate_queries_or_keys(qk[..., i * block:(i + 1) * block], p)
             for i, p in enumerate((t, h, w))]
    return torch.cat(parts + [qk[..., 3 * block:]], dim=-1)


def _linear(w, name, x, low):
    return _q(x, low) @ _q(w[f"{name}.weight"], low).T \
        + w[f"{name}.bias"].to(_dt(low))


def _ln(w, name, x, low, eps):
    return F.layer_norm(x.float(), x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], eps).to(_dt(low))


def _attention(w, pre, cfg, x, low):
    B, N, C = x.shape
    H = cfg["num_attention_heads"]
    D = C // H
    q, k, v = (_linear(w, f"{pre}.attention.{n}", x, low)
               .view(B, N, H, D).transpose(1, 2)
               for n in ("query", "key", "value"))
    q, k = rope(cfg, q), rope(cfg, k)
    out = torch.empty_like(q)
    kq, vq = _q(k, low), _q(v, low)
    for i in range(0, N, ATTN_ROWS):
        s = _q(q[:, :, i:i + ATTN_ROWS], low) @ kq.transpose(-1, -2)
        p = torch.softmax(s.float() / math.sqrt(D), dim=-1).to(q.dtype)
        out[:, :, i:i + ATTN_ROWS] = _q(p, low) @ vq
    o = out.transpose(1, 2).reshape(B, N, C)
    return _linear(w, f"{pre}.attention.proj", o, low)


def encoder(w: dict, cfg: dict, clip: torch.Tensor, low: bool = False
            ) -> torch.Tensor:
    """Preprocessed clips ``[B, T, 3, crop, crop]`` → features ``[B, N,
    hidden]`` after the final norm, float32."""
    eps = cfg["layer_norm_eps"]
    dt = _dt(low)
    e = "encoder.embeddings.patch_embeddings.proj"
    k = w[f"{e}.weight"]
    x = F.conv3d(_q(clip.to(dt).permute(0, 2, 1, 3, 4), low), _q(k, low),
                 w[f"{e}.bias"].to(dt), stride=k.shape[2:])
    x = x.flatten(2).transpose(1, 2)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}"
        x = x + _attention(w, pre, cfg, _ln(w, f"{pre}.norm1", x, low, eps),
                           low)
        h = _linear(w, f"{pre}.mlp.fc1", _ln(w, f"{pre}.norm2", x, low, eps),
                    low)
        x = x + _linear(w, f"{pre}.mlp.fc2", F.gelu(h), low)
    return _ln(w, "encoder.layernorm", x, low, eps).float()


def features(w: dict, cfg: dict, frames_u8: torch.Tensor,
             low: bool = False) -> torch.Tensor:
    """uint8 frames → features ``[clips, N, hidden]``, one clip at a
    time."""
    x = clips(cfg, frames_u8)
    return torch.cat([encoder(w, cfg, x[b:b + 1], low)
                      for b in range(len(x))])


def tubelets(cfg: dict, feats: torch.Tensor) -> torch.Tensor:
    """Features ``[clips, N, hidden]`` → one grid a tubelet, ``[clips * T',
    h, w, hidden]``: the RBVAE's inputs."""
    g = cfg["crop_size"] // cfg["patch_size"]
    return feats.reshape(-1, g, g, feats.shape[-1])
