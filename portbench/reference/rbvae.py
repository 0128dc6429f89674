"""The plain reference of the contrastive Recurrent Binary VAE ("Toward
Learning Symbolic Representations from Video", matt-suncy/symbols-from-video):
its encode, as the serving pipeline runs it, and its pair train step with
Adam.

Plain PyTorch in float32 with TF32 off, written from the model's equations:
a conv trunk of k3/s2/p1 convs with ReLU between them, an fc layer to the
latent logits, a stacked LSTM (gates i, f, g, o), Binary-Concrete codes
``sigmoid((h + s * logistic(u)) / T)``, and for training the mirrored
decoder (fc, transposed convs, sigmoid), the loss of recon MSE, the
Bernoulli KL of the relaxed codes, the contrastive margins on
``p = sigmoid(h)`` (pair and context-free passes) and the L1 brake on
``h``. It imports nothing of the program.

``low=True`` is the control, one precision below the configuration's
bfloat16: every conv, fc and LSTM product takes operands rounded to float8
e4m3 (one scale a tensor, its largest magnitude at 448), and every other
operation runs in bfloat16, as a program that moved its products to fp8
would run. ``low="bf16"`` runs it all in the configuration's own
bfloat16, products included: a witness of what that precision alone makes
of a number, not a control.

Parameters are a dict in torch's state-dict names and layouts (Conv2d
``[O, I, k, k]``, ConvTranspose2d ``[I, O, k, k]``, Linear ``[out, in]``,
``nn.LSTM``'s ``weight_ih_l{k}`` ...), float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def exact_matmuls() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, and back to float32. Autograd passes through it
    (straight-through)."""
    with torch.no_grad():
        f = t.detach().float()
        scale = f.abs().amax().clamp(min=1e-30) / E4M3_MAX
        r = ((f / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (r - t).detach()


def _q(t, low):
    """A product's operand: as it is, in fp8 (kept in bfloat16), or with
    ``low="bf16"`` in bfloat16."""
    if not low:
        return t
    t = t.to(torch.bfloat16)
    return t if low == "bf16" else fp8(t)


def _dt(low: bool):
    return torch.bfloat16 if low else torch.float32


def param_shapes(cfg: dict) -> dict:
    """Every parameter of the model, by state-dict name → shape."""
    k, L = cfg["conv_kernel"], cfg["latent_dim"]
    feats = list(cfg["conv_features"])
    chans = [cfg["in_channels"]] + feats
    drop = cfg["conv_dropout"] > 0
    step = 3 if drop else 2
    shapes = {}
    for i in range(len(feats)):
        shapes[f"encoder_cnn.conv.{step * i}.weight"] = (chans[i + 1],
                                                         chans[i], k, k)
        shapes[f"encoder_cnn.conv.{step * i}.bias"] = (chans[i + 1],)
    enc = encoded_dim(cfg)
    shapes["encoder_cnn.fc.weight"] = (L, enc)
    shapes["encoder_cnn.fc.bias"] = (L,)
    shapes["decoder_cnn.fc.weight"] = (enc, L)
    shapes["decoder_cnn.fc.bias"] = (enc,)
    dchans = feats[::-1] + [cfg["out_channels"]]
    for i in range(len(feats)):
        shapes[f"decoder_cnn.deconv.{step * i}.weight"] = (dchans[i],
                                                           dchans[i + 1], k, k)
        shapes[f"decoder_cnn.deconv.{step * i}.bias"] = (dchans[i + 1],)
    for rnn in ("encoder_rnn", "decoder_rnn"):
        for j in range(cfg["lstm_layers"]):
            for kind, shape in (("weight_ih", (4 * L, L)),
                                ("weight_hh", (4 * L, L)),
                                ("bias_ih", (4 * L,)), ("bias_hh", (4 * L,))):
                shapes[f"{rnn}.lstm.{kind}_l{j}"] = shape
    return shapes


def encoded_hw(cfg: dict) -> tuple[int, int]:
    h, w = cfg["input_hw"]
    for _ in cfg["conv_features"]:
        h = (h + 2 * cfg["conv_padding"] - cfg["conv_kernel"]) \
            // cfg["conv_stride"] + 1
        w = (w + 2 * cfg["conv_padding"] - cfg["conv_kernel"]) \
            // cfg["conv_stride"] + 1
    return h, w


def encoded_dim(cfg: dict) -> int:
    h, w = encoded_hw(cfg)
    return h * w * cfg["conv_features"][-1]


def fan_in(shape) -> int:
    """The fan-in of torch's default init: ``weight[0].numel()`` in all
    three layouts."""
    return int(np.prod(shape[1:]))


def init_weights(cfg: dict, seed: int, device, gains: dict | None = None
                 ) -> dict:
    """Seeded weights on ``device``, drawn by a generator there in one
    call: U(-b, b), b = gain / sqrt(fan_in) for convs and fc layers (torch's
    default law at gain 1), 1 / sqrt(H) for the LSTMs, ``bias_hh`` zero
    (the model keeps one bias a layer). ``gains``: a factor for the
    parameters whose names start with a key (biases share their layer's
    bound)."""
    gains = gains or {}
    shapes = param_shapes(cfg)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    H = cfg["latent_dim"]
    for (name, shape), n in zip(shapes.items(), sizes):
        chunk = flat[at:at + n].view(shape)
        at += n
        if ".lstm." in name:
            bound = 0.0 if "bias_hh" in name else 1.0 / math.sqrt(H)
        else:
            bound = 1.0 / math.sqrt(
                fan_in(shapes[name.replace(".bias", ".weight")]))
            for prefix, g in gains.items():
                if name.startswith(prefix):
                    bound *= g
        out[name] = (chunk * bound).contiguous()
    return out


def _convs(w: dict, prefix: str):
    ws = sorted((int(k.split(".")[2]), k) for k in w
                if k.startswith(prefix) and k.endswith(".weight"))
    return [(w[k], w[k.replace(".weight", ".bias")]) for _, k in ws]


def _dropout(h, rate: float, gen):
    """Keep with probability 1 - rate, kept values scaled by 1 / (1 -
    rate); the mask is ``rand(h.shape) < 1 - rate`` from ``gen``."""
    if gen is None:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), device=h.device,
                                                   dtype=h.dtype))


def trunk(w: dict, cfg: dict, x: torch.Tensor, low: bool = False,
          gen=None) -> torch.Tensor:
    """``x [N, H, W, C]`` in [0, 1] → the latent logits ``[N, L]``."""
    dt = _dt(low)
    h = x.to(dt).permute(0, 3, 1, 2)
    convs = _convs(w, "encoder_cnn.conv.")
    for i, (k, b) in enumerate(convs):
        h = F.conv2d(_q(h, low), _q(k, low), b.to(dt), cfg["conv_stride"],
                     cfg["conv_padding"])
        if i < len(convs) - 1 or cfg["conv_final_relu"]:
            h = torch.relu(h)
        if i < len(convs) - 1:
            h = _dropout(h, cfg["conv_dropout"], gen)
    h = h.reshape(h.shape[0], -1)
    return _q(h, low) @ _q(w["encoder_cnn.fc.weight"], low).T \
        + w["encoder_cnn.fc.bias"].to(dt)


def lstm(w: dict, prefix: str, cfg: dict, x: torch.Tensor,
         low: bool = False) -> torch.Tensor:
    """``x [B, T, L]`` → ``[B, T, L]``: each layer's gates ``x W_ih^T +
    h W_hh^T + b_ih + b_hh`` (i, f, g, o), ``c = s(f) c + s(i) tanh(g)``,
    ``h = s(o) tanh(c)``, from zero state; a residual path around each
    layer where the configuration has one."""
    B, T, _ = x.shape
    dt = _dt(low)
    h_in = x.to(dt)
    for j in range(cfg["lstm_layers"]):
        w_ih = _q(w[f"{prefix}.lstm.weight_ih_l{j}"], low)
        w_hh = _q(w[f"{prefix}.lstm.weight_hh_l{j}"], low)
        bias = (w[f"{prefix}.lstm.bias_ih_l{j}"]
                + w[f"{prefix}.lstm.bias_hh_l{j}"]).to(dt)
        H = w_hh.shape[1]
        h = torch.zeros(B, H, device=x.device, dtype=dt)
        c = torch.zeros(B, H, device=x.device, dtype=dt)
        outs = []
        for t in range(T):
            g = _q(h_in[:, t], low) @ w_ih.T + _q(h, low) @ w_hh.T + bias
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        out = torch.stack(outs, 1)
        h_in = h_in + out if cfg["lstm_residual"] else out
    return h_in


def frames01(frames_u8: torch.Tensor, hw) -> torch.Tensor:
    """uint8 ``[N, H, W, C]`` → float [0, 1] at the model's input size,
    by the bilinear resize that antialiases when it shrinks
    (``jax.image.resize``'s "bilinear")."""
    x = frames_u8.float() / 255.0
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def encode_h(w: dict, cfg: dict, frames_u8: torch.Tensor,
             low: bool = False) -> torch.Tensor:
    """The encoder LSTM's output ``h [N, L]`` of single frames (T = 1): a
    code bit is 1 where ``h`` plus the noise is above 0."""
    x = frames01(frames_u8, cfg["input_hw"])
    logits = trunk(w, cfg, x, low)
    return lstm(w, "encoder_rnn", cfg, logits[:, None], low)[:, 0]


# ------------------------------------------------------------------ training


def decoder(w: dict, cfg: dict, z: torch.Tensor, low: bool = False,
            gen=None) -> torch.Tensor:
    """``z [N, L]`` → frames ``[N, H, W, C]`` in (0, 1)."""
    eh, ew = encoded_hw(cfg)
    dt = _dt(low)
    h = _q(z.to(dt), low) @ _q(w["decoder_cnn.fc.weight"], low).T \
        + w["decoder_cnn.fc.bias"].to(dt)
    h = h.reshape(z.shape[0], -1, eh, ew)
    deconvs = _convs(w, "decoder_cnn.deconv.")
    for i, (k, b) in enumerate(deconvs):
        h = F.conv_transpose2d(_q(h, low), _q(k, low), b.to(dt),
                               cfg["conv_stride"], cfg["conv_padding"], 1)
        if i < len(deconvs) - 1:
            h = _dropout(torch.relu(h), cfg["conv_dropout"], gen)
    return torch.sigmoid(h).permute(0, 2, 3, 1)


def binary_concrete(h, u, temperature, scale, eps):
    """Relaxed codes ``sigmoid((h + scale * logistic(u)) / T)``."""
    noise = torch.log(u + eps) - torch.log(1.0 - u + eps)
    return torch.sigmoid((h + scale * noise) / temperature)


def contrastive(x1, x2, label: float, margin: float):
    d = torch.sqrt(((x1 - x2 + 1e-6) ** 2).sum(-1))
    return ((1.0 - label) * d * d
            + label * torch.clamp(margin - d, min=0.0) ** 2).mean()


def kl_bernoulli(z, p: float, eps: float = 1e-8):
    q = torch.sigmoid(z).clamp(eps, 1.0 - eps)
    kl = (q * (torch.log(q + eps) - math.log(p))
          + (1.0 - q) * (torch.log(1.0 - q + eps) - math.log1p(-p)))
    return kl.sum(-1).mean()


def pair_loss(w: dict, cfg: dict, tcfg: dict, batch_u8: torch.Tensor,
              temperature: float, draws, low: bool = False):
    """The contrastive pair objective of one step: ``batch_u8 [B, 2, S,
    H, W, C]``; both members as one ``[2B, S]`` batch (member 0's rows
    first); ``draws`` gives each pass's noise uniforms and dropout
    generators. Returns the total and its terms."""
    B, _, S = batch_u8.shape[:3]
    L = cfg["latent_dim"]
    x = batch_u8.float() / 255.0
    xm = x.transpose(0, 1).reshape((2 * B, S) + tuple(x.shape[3:]))
    flat = xm.reshape((2 * B * S,) + tuple(xm.shape[2:]))
    scale, eps = tcfg["noise_ratio"], cfg["bc_eps"]
    logits = trunk(w, cfg, flat, low, draws.dropout(0, 0)).reshape(
        2 * B, S, L)
    h = lstm(w, "encoder_rnn", cfg, logits, low)
    z = binary_concrete(h, draws.noise(0, h.shape).to(h.dtype), temperature,
                        scale, eps)
    d = lstm(w, "decoder_rnn", cfg, z, low)
    recon = decoder(w, cfg, d.reshape(2 * B * S, L), low, draws.dropout(0, 1))
    recon = recon.reshape(xm.shape)
    rec = ((recon - xm) ** 2).mean().float()
    kl = kl_bernoulli(z, tcfg["bernoulli_p"])
    p = torch.sigmoid(h)
    m = tcfg["margin"]
    aux = (contrastive(p[:B], p[B:], 0.0, m)
           + contrastive(p[:B, :-1], p[:B, 1:], 1.0, m))
    # The context-free pass: every frame alone (T = 1).
    lf = trunk(w, cfg, flat, low, draws.dropout(1, 0))
    hf = lstm(w, "encoder_rnn", cfg, lf[:, None], low)
    pf = torch.sigmoid(hf).reshape(2, B, S, L)
    aux = 0.5 * aux + 0.5 * (contrastive(pf[0], pf[1], 0.0, m)
                             + contrastive(pf[0][:, :-1], pf[0][:, 1:], 1.0,
                                           m))
    total = rec + tcfg["beta_kl"] * kl.float() \
        + tcfg["alpha"] * aux.float() \
        + tcfg["l1_logits"] * h.abs().sum(-1).mean().float()
    return total, {"recon": rec, "kl": kl, "aux": aux}


class Adam:
    """Adam with bias corrections (lr, betas (0.9, 0.999), eps 1e-8), on
    a dict of float32 leaves."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            params[k] -= self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + 1e-8)


def trainable(name: str) -> bool:
    """The model trains one LSTM bias a layer (``bias_ih``)."""
    return ".bias_hh_" not in name
