"""V-JEPA 2's video encoder (ViT-L/16 over 64-frame clips; "V-JEPA 2:
Self-Supervised Video Models Enable Understanding, Prediction and
Planning", ``facebookresearch/vjepa2``), the encoder of the clip path
(``perceptual/clip.py``).

The modules carry the published state-dict names
(``encoder.embeddings.patch_embeddings.proj.*``,
``encoder.layer.{i}.{norm1,attention.{query,key,value,proj},norm2,
mlp.{fc1,fc2}}.*``, ``encoder.layernorm.*``), so a checkpoint's encoder
loads with ``load_state_dict``. The predictor and the attentive pooler are
not on the encode path and are left out.

Equations: a tubelet embed (a ``Conv3d`` whose kernel is its stride,
``(tubelet, patch, patch)``, computed as one product over the flattened
tubelets), N tokens in (t, h, w) order, no absolute position and no class
token; pre-LN blocks ``x += proj(attn(LN1 x))``, ``x += fc2(GELU(fc1(LN2
x)))`` (GELU by erf, LayerNorm eps 1e-6), attention non-causal over all N
tokens, scaled by ``head_dim^-0.5``, with the 3-D rotary embedding of
``ops/rope.py`` on q and k; a final LayerNorm.

Rounding: products in the compute dtype with float32 parameters (as
``autoencoder_kl.py``), LayerNorm statistics and the rotary embedding in
float32, the residual stream in float32 (the branches' outputs are added
to it as they are), the features cast once to the compute dtype after the
final norm. Attention runs through ``ops/attention.flash_attention``: the
hand-written kernel on the card (``d64::flash_bf16_kernel``, the
warp-specialised wgmma kernel for D = 64), its plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from svtpu_torch import resolve_device
from svtpu_torch.config import VJEPA2Config
from svtpu_torch.ops.attention import flash_attention
from svtpu_torch.ops.conv import Dense, dense
from svtpu_torch.ops.rope import apply_rope, rope_tables


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, then the compute dtype."""

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dtype)


class PatchEmbeddings3D(nn.Module):
    """The tubelet embed: ``Conv3d(in, hidden, kernel = stride = (t, p,
    p))``, as one product over the flattened tubelets."""

    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        k = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_chans, cfg.hidden_size, k, k)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``[B, T, C, H, W]`` → tokens ``[B, N, hidden]``."""
        B, T, C, H, W = x.shape
        t, p = self.proj.kernel_size[:2]
        x = x.reshape(B, T // t, t, C, H // p, p, W // p, p)
        x = x.permute(0, 1, 4, 6, 3, 2, 5, 7).reshape(
            B, (T // t) * (H // p) * (W // p), C * t * p * p)
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        return dense(x, w, self.proj.bias, dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        self.patch_embeddings = PatchEmbeddings3D(cfg)


class RopeAttention(nn.Module):
    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        C = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query, self.key, self.value, self.proj = (
            Dense(C, C) for _ in range(4))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                dtype) -> torch.Tensor:
        B, N, C = x.shape
        H, D = self.heads, C // self.heads
        q, k, v = (m(x, dtype=dtype).view(B, N, H, D)
                   for m in (self.query, self.key, self.value))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        q, k, v = (t.transpose(1, 2).reshape(B * H, N, D) for t in (q, k, v))
        o = flash_attention(q, k, v).view(B, H, N, D).transpose(1, 2)
        return self.proj(o.reshape(B, N, C), dtype=dtype)


class MLP(nn.Module):
    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x, dtype=dtype)), dtype=dtype)


class Layer(nn.Module):
    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = LayerNorm(C, eps=eps)
        self.attention = RopeAttention(cfg)
        self.norm2 = LayerNorm(C, eps=eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                dtype) -> torch.Tensor:
        x = x + self.attention(self.norm1(x, dtype), cos, sin, dtype)
        return x + self.mlp(self.norm2(x, dtype), dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: VJEPA2Config):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.layer = nn.ModuleList(Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class VJEPA2(nn.Module):
    """The encoder: ``forward`` maps normalised clips ``[B, T, C, H, W]``
    (``T = frames_per_clip``, ``H = W = crop_size``) to features ``[B, N,
    hidden]`` in the compute dtype.

    ``device``: where the parameters and the rotary tables live; CUDA
    unless ``"cpu"`` is asked for. ``generator``: a ``torch.Generator`` on
    that device for the initial weights, the published init (truncated
    normal, std 0.02, for every product's weight; biases zero; LayerNorm
    ones and zeros); seed 0 when omitted.
    """

    def __init__(self, cfg: VJEPA2Config = VJEPA2Config(), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.encoder = _Encoder(cfg)
        cos, sin = rope_tables(cfg.grid, cfg.head_dim, dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.torch_dtype
        enc = self.encoder
        x = enc.embeddings.patch_embeddings(clips, dt).float()
        for layer in enc.layer:
            x = layer(x, self.rope_cos, self.rope_sin, dt)
        return enc.layernorm(x, dt)
