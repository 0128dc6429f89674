"""JAX parameter trees ↔ the port's torch state dict, and reference
checkpoints.

``from_jax_params`` is the inverse of
``svtpu/models/convert_rbvae.py::convert_rbvae``: it takes the
``{"params": ...}`` tree of ``svtpu``'s ``Seq2SeqBinaryVAE`` (as numpy
arrays, e.g. from :func:`load_params_npz`) and returns the reference torch
state dict, which ``svtpu_torch.models.rbvae.Seq2SeqBinaryVAE`` loads with
``load_state_dict``. ``to_jax_params`` is the port's copy of
``convert_rbvae`` (``:24-105``), its exact inverse, and
``load_rbvae_checkpoint`` reads a reference ``.pt`` (``:107-112``). The
layout traps are those ``convert_rbvae`` encodes:

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


def _fc_layout(cfg: RBVAEConfig):
    """The Sequential index step of the conv stacks, and the column
    permutations between the NHWC flatten order (``svtpu``) and the NCHW
    one (torch) of ``[n, H*W*C]`` fc matrices."""
    step = 3 if cfg.conv_dropout > 0 else 2
    C = cfg.conv_features[-1]
    H, W = cfg.encoded_hw

    def hwc_to_chw_cols(w):                  # [n, H*W*C] → [n, C*H*W]
        return np.asarray(w).reshape(-1, H, W, C).transpose(0, 3, 1, 2) \
            .reshape(w.shape[0], -1)

    def chw_to_hwc_cols(w):                  # [n, C*H*W] → [n, H*W*C]
        return np.asarray(w).reshape(-1, C, H, W).transpose(0, 2, 3, 1) \
            .reshape(w.shape[0], -1)

    return step, hwc_to_chw_cols, chw_to_hwc_cols


def from_jax_params(tree: Mapping, cfg: RBVAEConfig) -> Dict[str, torch.Tensor]:
    """``svtpu`` ``Seq2SeqBinaryVAE`` params → reference torch state dict."""
    p = tree["params"] if "params" in tree else tree
    step, hwc_to_chw_cols, _ = _fc_layout(cfg)
    C = cfg.conv_features[-1]
    H, W = cfg.encoded_hw
    L = cfg.latent_dim

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


def to_jax_params(state_dict: Mapping, cfg: RBVAEConfig) -> dict:
    """Reference torch state dict → ``svtpu``'s ``{"params": ...}`` tree of
    float32 numpy arrays; the exact inverse of :func:`from_jax_params`.
    Each LSTM layer's two biases are summed into ``svtpu``'s one."""
    sd = {k: (v.detach().cpu().float().numpy() if hasattr(v, "detach")
              else np.asarray(v, np.float32)) for k, v in state_dict.items()}
    step, _, chw_to_hwc_cols = _fc_layout(cfg)
    C = cfg.conv_features[-1]
    H, W = cfg.encoded_hw

    def c(a):
        return np.ascontiguousarray(a, np.float32)

    enc, dec = {}, {}
    for s in range(len(cfg.conv_features)):
        i = s * step
        enc[f"conv_{s}"] = {
            "kernel": c(np.transpose(sd[f"encoder_cnn.conv.{i}.weight"],
                                     (2, 3, 1, 0))),
            "bias": c(sd[f"encoder_cnn.conv.{i}.bias"])}
        dec[f"deconv_{s}"] = {
            "kernel": c(np.transpose(
                sd[f"decoder_cnn.deconv.{i}.weight"][:, :, ::-1, ::-1],
                (2, 3, 0, 1))),
            "bias": c(sd[f"decoder_cnn.deconv.{i}.bias"])}
    enc["fc"] = {"kernel": c(chw_to_hwc_cols(sd["encoder_cnn.fc.weight"]).T),
                 "bias": c(sd["encoder_cnn.fc.bias"])}
    dec["fc"] = {"kernel": c(chw_to_hwc_cols(sd["decoder_cnn.fc.weight"].T)),
                 "bias": c(sd["decoder_cnn.fc.bias"].reshape(C, H, W)
                           .transpose(1, 2, 0).reshape(-1))}
    params = {"encoder_cnn": enc, "decoder_cnn": dec}
    for name in ("encoder_rnn", "decoder_rnn"):
        rnn = {}
        for k in range(cfg.lstm_layers):
            pre = f"{name}.lstm"
            rnn[f"w_ih_{k}"] = c(sd[f"{pre}.weight_ih_l{k}"].T)
            rnn[f"w_hh_{k}"] = c(sd[f"{pre}.weight_hh_l{k}"].T)
            rnn[f"b_{k}"] = c(sd[f"{pre}.bias_ih_l{k}"]
                              + sd[f"{pre}.bias_hh_l{k}"])
        params[name] = rnn
    return {"params": params}


def load_rbvae_checkpoint(path: str | Path,
                          cfg: RBVAEConfig) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint (a state dict, or a training dict
    holding one under ``model_state_dict``,
    ``contrastive_RBVAE_train.py:668-673``) → the port's state dict, float32
    on the CPU. Raises when it does not fit ``cfg``'s model.

    Unpickles with ``weights_only=False``, as ``svtpu``'s reader does, so
    read only checkpoints you trust."""
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in obj.items()}
    Seq2SeqBinaryVAE(cfg, device="cpu").load_state_dict(sd)
    return sd
