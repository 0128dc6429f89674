"""AutoencoderKL weights into the port: from ``svtpu``'s flax tree, or from
an SD checkpoint's state dict.

``from_jax_params`` is the inverse of
``svtpu/perceptual/convert.py::convert_autoencoder_kl``: it takes the
``{"params": ...}`` tree of ``svtpu``'s ``AutoencoderKL`` (as numpy arrays)
and returns the CompVis-named state dict that
``svtpu_torch.models.autoencoder_kl.AutoencoderKL`` loads with
``load_state_dict``. Layout changes: flax conv kernels HWIO → torch OIHW;
GroupNorm ``scale`` → ``weight``.

``load_sd_first_stage`` keeps the ``first_stage_model.*`` tensors of a full
SD state dict and strips the prefix, as the reference's loader does
(``get_percep_embeddings.py:31-46``); ``load_torch_checkpoint`` reads that
state dict from an SD ``.ckpt`` (``svtpu/perceptual/convert.py:113-120``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from svtpu_torch.config import PerceptualConfig
from svtpu_torch.models.convert import f32_tensor

PREFIX = "first_stage_model."


def _resblock(tname: str, jpath: tuple, has_shortcut: bool):
    yield f"{tname}.norm1", jpath + ("norm1", "norm"), "norm"
    yield f"{tname}.conv1", jpath + ("conv1",), "conv"
    yield f"{tname}.norm2", jpath + ("norm2", "norm"), "norm"
    yield f"{tname}.conv2", jpath + ("conv2",), "conv"
    if has_shortcut:
        yield f"{tname}.nin_shortcut", jpath + ("nin_shortcut",), "conv"


def _mid(side: str):
    for b in ("block_1", "block_2"):
        yield from _resblock(f"{side}.mid.{b}", (side, f"mid_{b}"), False)
    yield f"{side}.mid.attn_1.norm", (side, "mid_attn_1", "norm", "norm"), \
        "norm"
    for name in ("q", "k", "v", "proj_out"):
        yield f"{side}.mid.attn_1.{name}", (side, "mid_attn_1", name), "conv"


def layer_names(cfg: PerceptualConfig) -> Iterator[Tuple[str, tuple, str]]:
    """Every layer as (CompVis module name, flax tree path, 'conv'/'norm'),
    in the order of ``convert_autoencoder_kl``."""
    yield "encoder.conv_in", ("encoder", "conv_in"), "conv"
    cin = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        for b in range(cfg.num_res_blocks):
            yield from _resblock(f"encoder.down.{i}.block.{b}",
                                 ("encoder", f"down_{i}_block_{b}"),
                                 cin != cfg.ch * mult)
            cin = cfg.ch * mult
        if i != len(cfg.ch_mult) - 1:
            yield (f"encoder.down.{i}.downsample.conv",
                   ("encoder", f"down_{i}_downsample", "conv"), "conv")
    yield from _mid("encoder")
    yield "encoder.norm_out", ("encoder", "norm_out", "norm"), "norm"
    yield "encoder.conv_out", ("encoder", "conv_out"), "conv"

    yield "decoder.conv_in", ("decoder", "conv_in"), "conv"
    yield from _mid("decoder")
    for i in reversed(range(len(cfg.ch_mult))):
        for b in range(cfg.num_res_blocks + 1):
            yield from _resblock(f"decoder.up.{i}.block.{b}",
                                 ("decoder", f"up_{i}_block_{b}"),
                                 cin != cfg.ch * cfg.ch_mult[i])
            cin = cfg.ch * cfg.ch_mult[i]
        if i != 0:
            yield (f"decoder.up.{i}.upsample.conv",
                   ("decoder", f"up_{i}_upsample", "conv"), "conv")
    yield "decoder.norm_out", ("decoder", "norm_out", "norm"), "norm"
    yield "decoder.conv_out", ("decoder", "conv_out"), "conv"
    yield "quant_conv", ("quant_conv",), "conv"
    yield "post_quant_conv", ("post_quant_conv",), "conv"


def from_jax_params(tree: Mapping,
                    cfg: PerceptualConfig = PerceptualConfig()
                    ) -> Dict[str, torch.Tensor]:
    """``svtpu`` ``AutoencoderKL`` params → CompVis-named torch state dict."""
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for tname, jpath, kind in layer_names(cfg):
        node = p
        for key in jpath:
            node = node[key]
        if kind == "conv":
            sd[f"{tname}.weight"] = f32_tensor(
                np.transpose(node["kernel"], (3, 2, 0, 1)))
        else:
            sd[f"{tname}.weight"] = f32_tensor(node["scale"])
        sd[f"{tname}.bias"] = f32_tensor(node["bias"])
    return sd


def load_sd_first_stage(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An SD state dict (``first_stage_model.*`` among other keys) or a bare
    AutoencoderKL one → the port's state dict, float32 tensors."""
    prefix = PREFIX if any(k.startswith(PREFIX) for k in state_dict) else ""
    return {k[len(prefix):]: torch.as_tensor(v, dtype=torch.float32)
            for k, v in state_dict.items() if k.startswith(prefix)}


def load_torch_checkpoint(path: str | Path) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.ckpt`` / ``.pt`` file (its ``state_dict``
    entry where it has one, as SD's Lightning checkpoints do) on the CPU;
    feed it to :func:`load_sd_first_stage`.

    Unpickles with ``weights_only=False``, as ``svtpu``'s reader does (SD's
    Lightning checkpoints can pickle training objects beside the weights),
    so read only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj)
    return {k: torch.as_tensor(v) for k, v in sd.items()}
