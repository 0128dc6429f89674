"""The port's loader of the genuine reference classes
(``svtpu_torch/utils/reference.py``) against ``svtpu/utils/reference.py``:
``det_rand``, the loader on an absent tree and on a tiny model file
written under a stand-in ``REF_MODELS``, the tree taken from
``SVTPU_REFERENCE`` alone, and ``stub_torchvision``."""
import importlib
import sys

import pytest
import torch

from svtpu.utils import reference as jref
from svtpu_torch.utils import reference


def test_det_rand_gives_half_and_restores():
    """Inside ``det_rand`` every ``torch.rand`` form gives 0.5 at the asked
    shape and dtype (a generator is ignored); outside it ``torch.rand`` is
    the original again."""
    orig = torch.rand
    with reference.det_rand():
        assert torch.rand is not orig
        for x in (torch.rand(2, 3), torch.rand((2, 3)),
                  torch.rand(torch.Size([2, 3]),
                             generator=torch.Generator().manual_seed(1))):
            assert x.shape == (2, 3) and torch.equal(x, torch.full((2, 3),
                                                                   0.5))
        assert torch.rand(4, dtype=torch.float64).dtype == torch.float64
        with jref.det_rand():
            assert torch.equal(torch.rand(3), torch.full((3,), 0.5))
    assert torch.rand is orig
    with pytest.raises(ValueError):
        with reference.det_rand():
            raise ValueError("restored on the way out")
    assert torch.rand is orig


def test_loader_returns_none_for_an_absent_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(reference, "REF_MODELS", tmp_path / "absent")
    for v in reference.VARIANTS:
        monkeypatch.delitem(sys.modules, f"{v}_RBVAE_model", raising=False)
        assert reference.load_reference_model_module(v) is None
    assert reference.VARIANTS == jref.VARIANTS
    with pytest.raises(ValueError, match="unknown variant"):
        reference.load_reference_model_module("bogus")


def test_reference_tree_comes_from_the_environment(tmp_path, monkeypatch):
    """``REF_MODELS`` is ``$SVTPU_REFERENCE/models`` and None where the
    variable is unset; with no tree the loader returns None without
    looking anywhere, and an explicit ``models_dir`` is used as given."""
    d = tmp_path / "models" / "simple_RBVAE"
    d.mkdir(parents=True)
    (d / "simple_RBVAE_model.py").write_text("VALUE = 5\n")
    monkeypatch.delitem(sys.modules, "simple_RBVAE_model", raising=False)
    try:
        monkeypatch.delenv("SVTPU_REFERENCE", raising=False)
        importlib.reload(reference)
        assert reference.REF_MODELS is None
        assert reference.load_reference_model_module("simple") is None
        assert "simple_RBVAE_model" not in sys.modules
        mod = reference.load_reference_model_module(
            "simple", models_dir=tmp_path / "models")
        assert mod.VALUE == 5
        monkeypatch.delitem(sys.modules, "simple_RBVAE_model")
        monkeypatch.setenv("SVTPU_REFERENCE", str(tmp_path))
        importlib.reload(reference)
        assert reference.REF_MODELS == tmp_path / "models"
        assert reference.load_reference_model_module("simple").VALUE == 5
    finally:
        monkeypatch.delenv("SVTPU_REFERENCE", raising=False)
        importlib.reload(reference)


def test_loader_imports_by_path(tmp_path, monkeypatch):
    """A ``<variant>_RBVAE_model.py`` under a stand-in ``REF_MODELS`` is
    imported by its path, with ``torchvision.transforms`` importable as
    the reference files need, no ``sys.path`` change, and cached in
    ``sys.modules`` under its name."""
    d = tmp_path / "contrastive_RBVAE"
    d.mkdir()
    (d / "contrastive_RBVAE_model.py").write_text(
        "import torchvision.transforms as T\n"
        "import torch\n"
        "class Model(torch.nn.Module):\n"
        "    def __init__(self):\n"
        "        super().__init__()\n"
        "        self.fc = torch.nn.Linear(3, 2)\n")
    monkeypatch.setattr(reference, "REF_MODELS", tmp_path)
    monkeypatch.delitem(sys.modules, "contrastive_RBVAE_model",
                        raising=False)
    for name in ("torchvision", "torchvision.transforms"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    path_before = list(sys.path)
    mod = reference.load_reference_model_module("contrastive")
    assert sys.path == path_before
    assert mod.__file__ == str(d / "contrastive_RBVAE_model.py")
    assert mod.Model().fc.weight.shape == (2, 3)
    assert reference.load_reference_model_module("contrastive") is mod
    assert sys.modules["contrastive_RBVAE_model"] is mod


def test_stub_torchvision_equals_svtpus(monkeypatch):
    """Both stubs install the same two empty modules, linked the same way,
    and leave an imported torchvision alone."""
    mods = {}
    for pkg in (reference, jref):
        for name in ("torchvision", "torchvision.transforms"):
            monkeypatch.delitem(sys.modules, name, raising=False)
        pkg.stub_torchvision()
        tv, tr = sys.modules["torchvision"], sys.modules["torchvision.transforms"]
        assert tv.transforms is tr
        mods[pkg] = (tv.__name__, tr.__name__, sorted(vars(tv)),
                     sorted(vars(tr)))
        pkg.stub_torchvision()
        assert sys.modules["torchvision"] is tv
    assert mods[reference] == mods[jref]
