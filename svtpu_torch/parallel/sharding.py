"""Parameter partition rules and tensor parallelism
(``svtpu/parallel/sharding.py``).

Rules are (regex over a state-dict name, spec) pairs, first match wins,
where a spec names the mesh axis that splits each leading dimension of the
tensor in torch's own layout (``mesh.Sharding``); unmatched parameters are
replicated. Torch's layouts are not flax's: a ``Linear.weight`` is
``[out, in]`` where a flax ``Dense`` kernel is ``[in, out]``, and a conv
weight is ``[out, in, kh, kw]`` where flax's is ``[kh, kw, in, out]``. So
``svtpu``'s ``P("model", None)`` on ``encoder_cnn/fc/kernel`` is
``(None, "model")`` on ``encoder_cnn.fc.weight`` here.

In ``svtpu`` XLA inserts the collectives a sharding needs. Here the RBVAE's
two big projections are parallelised by torch's tensor-parallel styles on
the mesh's "model" axis (``parallelize_rbvae``): the encoder fc by
``RowwiseParallel`` (this rank's input columns, the partial sums
all-reduced), the decoder fc by ``ColwiseParallel`` (this rank's output
rows and bias, the output columns all-gathered), both with replicated
inputs and outputs. They take the port's ``Dense``, whose forward takes the
compute dtype. Their parameters become ``DTensor``s; checkpoints hold the
whole tensors (``full_state_dict``, ``full_optimizer_state``) and load back
into this rank's blocks (``local_state``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import torch
from torch import nn

from svtpu_torch.parallel.distributed import is_dtensor
from svtpu_torch.parallel.mesh import Mesh, Sharding, Spec

# Row-parallel encoder projection ([L, D_in] split on D_in: the matmul's
# contraction is local, one all-reduce a layer) and column-parallel decoder
# projection ([D_out, L] split on D_out, with its bias: one all-gather).
RBVAE_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*encoder_cnn\.fc\.weight", (None, "model")),
    (r".*decoder_cnn\.fc\.weight", ("model", None)),
    (r".*decoder_cnn\.fc\.bias", ("model",)),
)

# AutoencoderKL: the wide convs' output channels, and the mid-block
# attention's q/k/v outputs and proj_out inputs.
AUTOENCODER_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*mid\.attn_1\.(q|k|v)\.weight", ("model", None, None, None)),
    (r".*mid\.attn_1\.proj_out\.weight", (None, "model", None, None)),
    (r".*conv(1|2|_in|_out)\.weight", ("model", None, None, None)),
)


def _spec_for(name: str, rules) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def _named_tensors(module_or_state_dict) -> Mapping[str, torch.Tensor]:
    if isinstance(module_or_state_dict, nn.Module):
        return dict(module_or_state_dict.named_parameters())
    return module_or_state_dict


def params_shardings(module_or_state_dict, mesh: Mesh,
                     rules=RBVAE_TP_RULES) -> Dict[str, Sharding]:
    """A ``Sharding`` for every parameter of a module (or tensor of a state
    dict), by name. A rule whose split dimension the mesh axis does not
    divide falls back to replication (tiny models under big meshes)."""
    out = {}
    for name, t in _named_tensors(module_or_state_dict).items():
        spec = _spec_for(name, rules)
        ok = all(axis is None or (d < t.ndim
                                  and t.shape[d] % mesh.size(axis) == 0)
                 for d, axis in enumerate(spec))
        out[name] = Sharding(mesh, spec if ok else ())
    return out


def shard_params(module_or_state_dict, mesh: Mesh,
                 rules=RBVAE_TP_RULES) -> Dict[str, torch.Tensor]:
    """This rank's block of every tensor, by name (copies)."""
    sh = params_shardings(module_or_state_dict, mesh, rules)
    return {name: sh[name].local(t).detach().clone()
            for name, t in _named_tensors(module_or_state_dict).items()}


def parallelize_rbvae(model: nn.Module, mesh: Mesh, axis: str = "model",
                      rules=RBVAE_TP_RULES) -> None:
    """Shard the RBVAE's projections over ``axis`` in place, by ``rules``:
    a fc whose weight the rules split on its input columns runs
    ``RowwiseParallel``, on its output rows ``ColwiseParallel``; one whose
    rule fell back to replication (or a mesh without a process group)
    stays a ``Dense``."""
    if mesh.device_mesh is None:
        return
    # Here, not at module level: torch.distributed.tensor is loaded only
    # where a "model" axis needs it (``distributed.is_dtensor``).
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    shardings = params_shardings(model, mesh, rules)
    styles = {(None, axis): RowwiseParallel, (axis, None): ColwiseParallel}
    plan = {prefix: styles[spec](input_layouts=Replicate(),
                                 output_layouts=Replicate())
            for prefix in ("encoder_cnn.fc", "decoder_cnn.fc")
            if (spec := shardings[f"{prefix}.weight"].spec) in styles}
    if plan:
        parallelize_module(model, mesh.device_mesh[axis], plan)


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every ``DTensor`` whole, so that a
    tensor-parallel checkpoint loads into a one-device model. Every rank
    of the mesh must call it."""
    return {k: _whole(v) for k, v in model.state_dict().items()}


def full_optimizer_state(opt_state: dict) -> dict:
    """``optimizer.state_dict()`` with every ``DTensor`` moment whole. Every
    rank of the mesh must call it."""
    return {**opt_state, "state": {
        i: {k: _whole(v) for k, v in s.items()}
        for i, s in opt_state["state"].items()}}


def local_state(model: nn.Module, model_sd: dict, opt_state: dict,
                names: Sequence[str]):
    """A checkpoint's whole model and optimizer state, as ``DTensor``s laid
    out like ``model``'s parameters where those are (the inverse of
    ``full_state_dict`` and ``full_optimizer_state``). ``names[i]``: the
    name of the optimizer's ``i``-th parameter."""
    params = dict(model.named_parameters())

    def like(t, name):
        p = params.get(name)
        if not is_dtensor(p) or not isinstance(t, torch.Tensor) \
                or t.shape != p.shape:
            return t
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(p.device_mesh.device_type),
                                 p.device_mesh, p.placements)

    model_sd = {k: like(v, k) for k, v in model_sd.items()}
    state = {i: {k: like(v, names[int(i)]) for k, v in s.items()}
             for i, s in opt_state["state"].items()}
    return model_sd, {**opt_state, "state": state}
