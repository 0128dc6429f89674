"""Import helpers for the genuine reference code; the port's copy of
``svtpu/utils/reference.py``.

The reference tree (the directory holding ``models/``) is named by the
environment variable ``SVTPU_REFERENCE``; nothing is looked for where it
is unset. The reference is PyTorch, so a test can hold the port's modules
directly against the reference classes wherever that tree is given; where
it is not, or lacks the file, ``load_reference_model_module`` returns None
and the caller skips.

The reference RBVAE model files import ``torchvision.transforms`` at module
top (``contrastive_RBVAE_model.py:12`` and siblings) but never use it in
the model classes; ``stub_torchvision`` makes them importable without
torchvision. Modules load by file path
(``importlib.util.spec_from_file_location``), with no ``sys.path``
change, so the vendored tree cannot shadow installed packages.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os
import sys
import types
from pathlib import Path

import torch

# ``$SVTPU_REFERENCE/models``; None where the variable is unset.
REF_MODELS = (Path(os.environ["SVTPU_REFERENCE"]) / "models"
              if os.environ.get("SVTPU_REFERENCE") else None)

VARIANTS = ("simple", "contrastive", "percep", "triplet")


def stub_torchvision() -> None:
    """Empty ``torchvision`` and ``torchvision.transforms`` modules in
    ``sys.modules``, unless torchvision is imported already."""
    if "torchvision" in sys.modules:
        return
    tv = types.ModuleType("torchvision")
    tr = types.ModuleType("torchvision.transforms")
    tv.transforms = tr
    sys.modules["torchvision"] = tv
    sys.modules["torchvision.transforms"] = tr


def load_reference_model_module(variant: str, models_dir=None):
    """The genuine ``<variant>_RBVAE_model`` module from ``models_dir``
    (``REF_MODELS`` by default), or None where no tree is given or the
    file is absent."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    models_dir = REF_MODELS if models_dir is None else Path(models_dir)
    if models_dir is None:
        return None
    stub_torchvision()
    name = f"{variant}_RBVAE_model"
    if name in sys.modules:
        return sys.modules[name]
    path = models_dir / f"{variant}_RBVAE" / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def det_rand():
    """Patch ``torch.rand`` to return U = 0.5 so the reference's logistic
    noise ``log(U+eps) - log(1-U+eps)`` is exactly zero (deterministic
    forward for the simple/triplet variants, whose
    ``binary_concrete_logits`` has no ``noise_ratio``)."""
    orig = torch.rand

    def rand05(*shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, torch.Size)):
            shape = tuple(shape[0])
        kw.pop("generator", None)
        return torch.full(shape, 0.5, **kw)

    torch.rand = rand05
    try:
        yield
    finally:
        torch.rand = orig
