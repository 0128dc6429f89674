"""JAX parameter trees → the port's torch state dict.

The inverse of ``svtpu/models/convert_rbvae.py::convert_rbvae``: it takes the
``{"params": ...}`` tree of ``svtpu``'s ``Seq2SeqBinaryVAE`` (as numpy
arrays, e.g. from :func:`load_params_npz`) and returns the reference torch
state dict, which ``svtpu_torch.models.rbvae.Seq2SeqBinaryVAE`` loads with
``load_state_dict``. The layout traps are those ``convert_rbvae`` encodes:

  * conv kernels: HWIO → OIHW;
  * transposed-conv kernels: stored flipped in the equivalent-conv layout
    → ``ConvTranspose2d``'s ``[I, O, kh, kw]``, flipped back;
  * LSTM: one folded bias → ``bias_ih`` (the sum) and zeros in ``bias_hh``;
  * both fc layers: NHWC flatten order → torch's NCHW order;
  * Sequential indices {0,3,6} with dropout, {0,2,4} without.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from svtpu_torch.config import RBVAEConfig


def load_params_npz(path: str | Path) -> dict:
    """Read a ``save_params_npz`` archive ('/'-joined tree paths) into a
    nested dict of numpy arrays (``svtpu/training/checkpoints.py:111-122``)."""
    with np.load(path) as z:
        tree: dict = {}
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def f32_tensor(a) -> torch.Tensor:
    """A float32 CPU tensor holding a copy of ``a`` (numpy or array-like)."""
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def from_jax_params(tree: Mapping, cfg: RBVAEConfig) -> Dict[str, torch.Tensor]:
    """``svtpu`` ``Seq2SeqBinaryVAE`` params → reference torch state dict."""
    p = tree["params"] if "params" in tree else tree
    step = 3 if cfg.conv_dropout > 0 else 2
    C = cfg.conv_features[-1]
    H, W = cfg.encoded_hw
    L = cfg.latent_dim

    def hwc_to_chw_cols(w):                  # [n, H*W*C] → [n, C*H*W]
        return np.asarray(w).reshape(-1, H, W, C).transpose(0, 3, 1, 2) \
            .reshape(w.shape[0], -1)

    sd = {}
    enc, dec = p["encoder_cnn"], p["decoder_cnn"]
    for s in range(len(cfg.conv_features)):
        conv, deconv = enc[f"conv_{s}"], dec[f"deconv_{s}"]
        sd[f"encoder_cnn.conv.{s * step}.weight"] = f32_tensor(
            np.transpose(conv["kernel"], (3, 2, 0, 1)))
        sd[f"encoder_cnn.conv.{s * step}.bias"] = f32_tensor(conv["bias"])
        sd[f"decoder_cnn.deconv.{s * step}.weight"] = f32_tensor(
            np.transpose(deconv["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1])
        sd[f"decoder_cnn.deconv.{s * step}.bias"] = f32_tensor(deconv["bias"])
    sd["encoder_cnn.fc.weight"] = f32_tensor(
        hwc_to_chw_cols(np.asarray(enc["fc"]["kernel"]).T))
    sd["encoder_cnn.fc.bias"] = f32_tensor(enc["fc"]["bias"])
    sd["decoder_cnn.fc.weight"] = f32_tensor(
        hwc_to_chw_cols(np.asarray(dec["fc"]["kernel"])).T)
    sd["decoder_cnn.fc.bias"] = f32_tensor(
        np.asarray(dec["fc"]["bias"]).reshape(H, W, C).transpose(2, 0, 1)
        .reshape(-1))
    for name in ("encoder_rnn", "decoder_rnn"):
        rnn = p[name]
        for k in range(cfg.lstm_layers):
            sd[f"{name}.lstm.weight_ih_l{k}"] = f32_tensor(
                np.asarray(rnn[f"w_ih_{k}"]).T)
            sd[f"{name}.lstm.weight_hh_l{k}"] = f32_tensor(
                np.asarray(rnn[f"w_hh_{k}"]).T)
            sd[f"{name}.lstm.bias_ih_l{k}"] = f32_tensor(rnn[f"b_{k}"])
            sd[f"{name}.lstm.bias_hh_l{k}"] = torch.zeros(4 * L)
    return sd
