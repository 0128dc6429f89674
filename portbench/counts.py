"""Operations and bytes of the work a cell asks for, counted from shapes.

Frozen here so that a change to the program cannot move its own yardstick.
A multiply-add counts two operations. Bytes count each input read once and
each output written once, whatever a kernel reads again. The peaks are
NVIDIA's for one H100 SXM (dense, no sparsity).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def _conv_out(n: int, k: int = 3, s: int = 2, p: int = 1) -> int:
    return (n + 2 * p - k) // s + 1


def trunk_macs(cfg: dict) -> list[int]:
    """Multiply-adds of each conv of the RBVAE's encoder trunk, one frame."""
    (h, w), k = cfg["input_hw"], cfg["conv_kernel"]
    s, p = cfg["conv_stride"], cfg["conv_padding"]
    chans = [cfg["in_channels"]] + list(cfg["conv_features"])
    out = []
    for i in range(len(cfg["conv_features"])):
        h, w = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
        out.append(h * w * chans[i + 1] * chans[i] * k * k)
    return out


def encoded_dim(cfg: dict) -> int:
    (h, w), k = cfg["input_hw"], cfg["conv_kernel"]
    for _ in cfg["conv_features"]:
        h = _conv_out(h, k, cfg["conv_stride"], cfg["conv_padding"])
        w = _conv_out(w, k, cfg["conv_stride"], cfg["conv_padding"])
    return h * w * cfg["conv_features"][-1]


def lstm_macs(cfg: dict) -> int:
    """One frame through one LSTM stack: input and recurrent products of
    every layer."""
    L = cfg["latent_dim"]
    return cfg["lstm_layers"] * 4 * L * 2 * L


def fused_conv01(cfg: dict, batch: int) -> tuple[float, float]:
    """``fused_conv01`` (conv0 + ReLU + conv1 + ReLU) on ``batch`` frames:
    (operations, bytes). The frames come in the compute dtype (2 bytes),
    the weights and biases in float32, the output in the compute dtype."""
    m0, m1 = trunk_macs(cfg)[:2]
    (h, w), c = cfg["input_hw"], cfg["in_channels"]
    f0, f1 = cfg["conv_features"][:2]
    k2 = cfg["conv_kernel"] ** 2
    ho, wo = _conv_out(_conv_out(h)), _conv_out(_conv_out(w))
    weights = 4 * (f0 * c * k2 + f0 + f1 * f0 * k2 + f1)
    nbytes = batch * (h * w * c + ho * wo * f1) * 2 + weights
    return 2.0 * batch * (m0 + m1), float(nbytes)


def flash_attention(b: int, n: int, d: int) -> tuple[float, float]:
    """Single-head attention over ``[b, n, d]`` bf16 q, k, v: QK^T and PV,
    2 n^2 d multiply-adds a row; q, k, v read and o written once."""
    return 4.0 * b * n * n * d, float(4 * b * n * d * 2)


def lstm_binary_concrete(cfg: dict, batch: int, steps: int = 1
                         ) -> tuple[float, float]:
    """The encoder LSTM with the sampler, ``batch`` sequences of ``steps``:
    (operations of its products, bytes of its logits in and codes out in
    the compute dtype plus its float32 weights)."""
    L, layers = cfg["latent_dim"], cfg["lstm_layers"]
    weights = 4 * layers * (4 * L * L * 2 + 8 * L)
    return (2.0 * batch * steps * lstm_macs(cfg),
            float(batch * steps * L * 2 * 2 + weights))


def train_step_flops(cfg: dict, frames: int) -> float:
    """A pair train step on ``frames`` frames: each through the encoder and
    the decoder, and through the encoder once more (the context-free
    pass); the backward twice the forward. Convs, fc layers and LSTM
    products (``train_step_flops`` of the smoke script)."""
    enc = sum(trunk_macs(cfg))
    dec = enc                                   # mirrored transposed convs
    fc = encoded_dim(cfg) * cfg["latent_dim"]
    lstm = lstm_macs(cfg)
    fwd_macs = frames * (2 * (enc + fc + lstm) + dec + fc + lstm)
    return 3 * 2 * fwd_macs


def pixel_encode_flops(cfg: dict) -> float:
    """One frame's encode at the model's input size: trunk, fc, encoder
    LSTM (the resize before it is not counted)."""
    return 2.0 * (sum(trunk_macs(cfg)) + encoded_dim(cfg) * cfg["latent_dim"]
                  + lstm_macs(cfg))


def sd_encode_flops(sd: dict, h: int, w: int) -> float:
    """One frame of the SD first stage's encoder at ``h`` x ``w``
    (``configs/stable-diffusion/v1-inference.yaml``'s ``ddconfig``): convs,
    the mid block's attention (q, k, v, proj and its two products), quant
    conv. Norms and activations are not counted."""
    ch, mult = sd["ch"], sd["ch_mult"]
    macs = h * w * sd["in_channels"] * ch * 9               # conv_in
    c_in = ch
    for lvl, m in enumerate(mult):
        c_out = ch * m
        for _ in range(sd["num_res_blocks"]):
            macs += h * w * 9 * (c_in * c_out + c_out * c_out)
            if c_in != c_out:
                macs += h * w * c_in * c_out                 # nin_shortcut
            c_in = c_out
        if lvl != len(mult) - 1:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1        # pad (0,1,0,1)
            macs += h * w * 9 * c_in * c_in
    n = h * w
    macs += 2 * n * 9 * 2 * c_in * c_in                     # two res blocks
    macs += 4 * n * c_in * c_in + 2 * n * n * c_in          # attention
    z2 = 2 * sd["z_channels"]
    macs += n * 9 * c_in * z2 + n * z2 * 2 * sd["embed_dim"]
    return 2.0 * macs


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory's."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
