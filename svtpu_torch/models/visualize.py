"""Model smoke test and architecture summary
(``svtpu/models/visualize.py``; the reference's
``models/contrastive_RBVAE/visualize_RBVAE.py:8-33``, a dummy-input
forward while exporting a TensorBoard graph).

A dummy forward on the device, with every module's output shapes caught by
forward hooks, and a table of module paths, parameter shapes and counts,
output shapes and the totals, in place of flax's ``nn.tabulate``; written
into a TensorBoard text summary where tensorboardX imports.

    python -m svtpu_torch.models.visualize --variant contrastive
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from svtpu_torch import resolve_device
from svtpu_torch.config import RBVAEConfig, rbvae_variant
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE


def _shapes(out) -> list:
    if isinstance(out, torch.Tensor):
        return [list(out.shape)]
    if isinstance(out, (tuple, list)):
        return [s for o in out for s in _shapes(o)]
    return []


def _rows(model: nn.Module, outputs: dict):
    """One row a parameter: (module path, parameter, shape, count, outputs
    of the module's first call)."""
    for path, m in model.named_modules():
        params = list(m.named_parameters(recurse=False))
        if not params and path not in outputs:
            continue
        outs = " ".join(str(s) for s in outputs.get(path, [])) or "-"
        if not params:
            yield path or "(model)", "", "", "", outs
        for i, (name, p) in enumerate(params):
            yield (path, name, str(list(p.shape)), f"{p.numel():,}",
                   outs if i == 0 else "")


def summarize(cfg: RBVAEConfig, batch: int = 1, time_steps: int = 2,
              log_dir: Optional[str] = None, device=None) -> str:
    """Run a dummy forward on ``device`` (the card unless ``"cpu"`` is
    asked for) and return the parameter and shape table. Nothing in it
    depends on the device."""
    dev = resolve_device(device)
    model = Seq2SeqBinaryVAE(cfg, device=dev)
    x = torch.zeros((batch, time_steps) + tuple(cfg.input_hw)
                    + (cfg.in_channels,), device=dev)
    outputs = {}

    def hook(path):
        def record(_module, _inputs, out):
            outputs.setdefault(path, _shapes(out))
        return record

    handles = [m.register_forward_hook(hook(p))
               for p, m in model.named_modules()]
    try:
        with torch.no_grad():
            out = model(x, 1.0, False, deterministic=True)
    finally:
        for h in handles:
            h.remove()
    # Smoke-test the forward as the reference does.
    assert out.x_recon.shape == x.shape, (out.x_recon.shape, x.shape)

    total = sum(p.numel() for p in model.parameters())
    hh = sum(p.numel() for n, p in model.named_parameters()
             if ".bias_hh_l" in n)
    header = ("module", "parameter", "shape", "count", "output shapes")
    rows = [header] + list(_rows(model, outputs))
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    fmt = " | ".join(f"{{:{w}}}" for w in widths)
    lines = [f"Seq2SeqBinaryVAE: input {list(x.shape)} float32, compute "
             f"{cfg.compute_dtype}", fmt.format(*header),
             "-+-".join("-" * w for w in widths)]
    lines = [ln.rstrip() for ln in lines + [fmt.format(*r) for r in rows[1:]]]
    lines += [f"parameters held: {total:,}",
              f"trainable: {total - hh:,} (each LSTM layer's bias_ih + "
              f"bias_hh trains as one bias, as svtpu holds it; "
              f"{hh:,} bias_hh entries are counted in bias_ih)"]
    table = "\n".join(lines)
    if log_dir:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            w = SummaryWriter(log_dir)
            w.add_text("model_summary", f"```\n{table}\n```")
            w.close()
    return table


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="contrastive")
    p.add_argument("--latent-dim", type=int, default=32)
    p.add_argument("--log-dir")
    p.add_argument("--device", help="cuda (the default) or cpu")
    a = p.parse_args()
    print(summarize(rbvae_variant(a.variant, a.latent_dim),
                    log_dir=a.log_dir, device=a.device))
