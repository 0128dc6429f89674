"""The port's evaluation suite on the CPU: the counterparts of
``tests/test_evaluation.py`` (perturbations, the consistency protocol,
Hamming, projections, the linear probe, explicit labels, the
``pixel_to_input`` hook, ``umap_min``), checkpoints read back into a
bundle, and the guards (no card and no device raises; the modules import
without sklearn and matplotlib)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svtpu_torch.data.segments import assign_label
from svtpu_torch.evaluation.common import RBVAEBundle
from svtpu_torch.evaluation.consistency import (evaluate_consistency,
                                                perturb_embeddings,
                                                perturb_frames, plot_results,
                                                write_csv)
from svtpu_torch.evaluation.hamming import (adjacent_hamming,
                                            evaluate_hamming, modal_codes)
from svtpu_torch.evaluation.hamming import plot_results as plot_hamming
from svtpu_torch.evaluation.hamming import write_csv as write_hamming
from svtpu_torch.evaluation.linear_probe import evaluate_linear_probe
from svtpu_torch.evaluation.projections import evaluate_projections, project
from svtpu_torch.ops.image import add_gaussian_noise, add_occlusion, to_pm1
from svtpu_torch.training.checkpoints import BestCheckpointer

from _torch_port import eval_frames, eval_model

ROOT = Path(__file__).resolve().parent.parent
IDX = list(range(30))
FLAGS = [10, 20]
EVAL_MODULES = ("common", "hamming", "consistency", "bitmatch", "tradeoff",
                "umap_min", "projections", "linear_probe")


@pytest.fixture(scope="module")
def bundle():
    _, _, tcfg, sd = eval_model()
    return RBVAEBundle(tcfg, sd, name="test_model", device="cpu")


@pytest.fixture(scope="module")
def frames():
    return eval_frames()


def test_perturbations_properties():
    x = torch.full((2, 16, 16, 3), 0.5)
    noisy = add_gaussian_noise(x, torch.Generator().manual_seed(0), 0.1)
    assert noisy.shape == x.shape
    assert float(noisy.min()) >= 0 and float(noisy.max()) <= 1
    assert not torch.allclose(noisy, x)

    x2 = torch.full((1, 16, 16, 3), 0.9)
    occ = add_occlusion(x2, torch.Generator().manual_seed(1), 0.25)
    side = int((0.25 * 16 * 16) ** 0.5)
    assert int((occ == 0.5).all(dim=-1).sum()) == side * side
    again = add_occlusion(x2, torch.Generator().manual_seed(1), 0.25)
    assert torch.equal(occ, again)
    assert torch.equal(to_pm1(torch.tensor([0.0, 0.5, 1.0])),
                       torch.tensor([-1.0, 0.0, 1.0]))


def test_perturb_frames_dispatch(frames):
    assert perturb_frames(frames, "clean", 0, device="cpu") is frames
    n = perturb_frames(frames, "noise", 0, device="cpu")
    o = perturb_frames(frames, "occlusion", 0, device="cpu")
    assert n.shape == o.shape == frames.shape
    assert n.dtype == o.dtype == np.float32
    with pytest.raises(ValueError):
        perturb_frames(frames, "bogus", 0, device="cpu")


def test_consistency_protocol(bundle, frames, tmp_path):
    results = evaluate_consistency(bundle, frames, IDX, FLAGS, num_trials=2,
                                   perturbations=("clean", "noise"))
    assert len(results) == 2
    for r in results:
        assert 0.0 <= r.mean <= 1.0
        assert len(r.trials) == 2
    write_csv(results, tmp_path / "c.csv")
    assert (tmp_path / "c.csv").read_text().startswith("model,")
    plot_results(results, tmp_path / "c.png")
    assert (tmp_path / "c.png").exists()


def test_hamming(bundle, frames, tmp_path):
    res = evaluate_hamming(bundle, frames, IDX, FLAGS)
    assert res["modal_codes"].shape == (3, 6)
    assert res["hamming"].shape == (2,)
    write_hamming({"m": res}, tmp_path / "h.csv")
    assert (tmp_path / "h.csv").read_text().splitlines()[1].startswith(
        "m,0-1,")
    plot_hamming({"m": res}, tmp_path / "h.png")
    assert (tmp_path / "h.png").exists()

    modal = np.array([[0, 0, 1], [1, 0, 1], [1, 1, 0]], np.uint8)
    np.testing.assert_array_equal(adjacent_hamming(modal), [1, 2])

    codes = np.array([[1, 1], [1, 1], [0, 1]])
    labels = np.array([0, 0, 1])
    m = modal_codes(codes, labels, 2)
    np.testing.assert_array_equal(m, [[1, 1], [0, 1]])


def test_projections(bundle, frames, tmp_path):
    written = evaluate_projections(bundle, frames, IDX, FLAGS, tmp_path,
                                   methods=("pca",))
    assert "pca" in written
    assert (tmp_path / "test_model_pca.png").exists()


def test_linear_probe(bundle, frames, tmp_path):
    m = evaluate_linear_probe(bundle, frames,
                              example_path=tmp_path / "ex.png")
    assert set(m) == {"r2", "mse", "mae", "explained_variance"}
    assert np.isfinite(m["mse"])
    assert (tmp_path / "ex.png").exists()


def test_consistency_explicit_labels(bundle, frames):
    """Explicit per-frame labels (one global state axis across videos) give
    the same result as the flags' labels when they say the same."""
    ref = evaluate_consistency(bundle, frames, IDX, FLAGS, num_trials=2,
                               perturbations=("clean",))
    lab = [assign_label(i, FLAGS) for i in IDX]
    via_labels = evaluate_consistency(bundle, frames, IDX, flags=[],
                                      num_trials=2,
                                      perturbations=("clean",), labels=lab)
    assert via_labels[0].trials == ref[0].trials


def test_consistency_pixel_to_input_hook(bundle, frames):
    """The percep-path hook (perturbed pixels → model-input space) is
    called once a trial with the trial seed."""
    calls = []

    def fake_hook(frames01, seed):
        calls.append(seed)
        return frames01

    res = evaluate_consistency(bundle, frames, IDX, FLAGS, num_trials=2,
                               perturbations=("clean",),
                               pixel_to_input=fake_hook)
    assert calls == [0, 1000]
    assert 0.0 <= res[0].mean <= 1.0


def test_umap_min_separates_blobs():
    """The port's minimal UMAP: three well-separated 10-D Gaussian blobs
    land in three separated 2-D clusters."""
    from svtpu_torch.evaluation.umap_min import umap_embed

    rng = np.random.default_rng(0)
    centers = rng.normal(0, 10, (3, 10))
    x = np.concatenate([c + rng.normal(0, 0.3, (40, 10)) for c in centers])
    labels = np.repeat(np.arange(3), 40)
    xy = umap_embed(x, n_neighbors=10, n_epochs=150, seed=0)
    assert xy.shape == (120, 2) and np.isfinite(xy).all()
    cents = np.stack([xy[labels == k].mean(0) for k in range(3)])
    intra = max(np.linalg.norm(xy[labels == k] - cents[k], axis=1).mean()
                for k in range(3))
    inter = min(np.linalg.norm(cents[i] - cents[j])
                for i in range(3) for j in range(i + 1, 3))
    assert inter > 2.5 * intra, (inter, intra)


def test_projection_umap_fallback(monkeypatch):
    """project(method='umap') falls back to umap_min when umap-learn is
    absent."""
    monkeypatch.setitem(sys.modules, "umap", None)
    codes = np.random.default_rng(1).uniform(size=(60, 8))
    xy = project(codes, "umap", seed=0)
    assert xy is not None and xy.shape == (60, 2)


def test_bundle_from_a_trainer_checkpoint(tmp_path, frames):
    """``from_checkpoint`` reads the tree ``Trainer.train`` saves (``{"model":
    ..., "optimizer": ...}``): every tensor comes back exactly, and the
    bundle encodes as one built from the state dict."""
    _, _, tcfg, sd = eval_model()
    ckpt = BestCheckpointer(tmp_path)
    ckpt.save({"model": sd, "optimizer": {"state": {}}}, epoch=4, metric=0.5)
    loaded = RBVAEBundle.from_checkpoint(str(tmp_path), tcfg, name="ck",
                                         device="cpu")
    got = loaded.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    direct = RBVAEBundle(tcfg, sd, device="cpu")
    np.testing.assert_array_equal(loaded.encode(frames, seed=3),
                                  direct.encode(frames, seed=3))


def test_uint8_frames_are_scaled_as_svtpu_scales_them(bundle, frames):
    """uint8 frames are divided by 255 on the device, as svtpu's bundle
    divides them on the host."""
    u8 = (frames * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        bundle.encode(u8, noise=False),
        bundle.encode(u8.astype(np.float32) / 255.0, noise=False))


def test_entry_points_need_a_card_or_cpu(monkeypatch, tmp_path, frames):
    """Without a card, a bundle, its checkpoint reader and the
    perturbations raise unless given device='cpu'."""
    _, _, tcfg, sd = eval_model()
    BestCheckpointer(tmp_path).save({"model": sd}, epoch=0, metric=0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RBVAEBundle(tcfg, sd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RBVAEBundle.from_checkpoint(str(tmp_path), tcfg)
    for fn in (perturb_frames, perturb_embeddings):
        for kind in ("clean", "noise", "occlusion"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(frames, kind, 0)
    RBVAEBundle(tcfg, sd, device="cpu")
    perturb_embeddings(frames, "noise", 0, device="cpu")


def test_modules_import_without_sklearn_and_matplotlib():
    """The card's host has neither: every evaluation module imports
    without them (they are imported inside the functions that use them).
    In a fresh interpreter, with both blocked."""
    code = "\n".join([
        "import sys",
        "for mod in ('sklearn', 'matplotlib', 'umap'):",
        "    sys.modules[mod] = None",
        "import importlib",
        f"for name in {EVAL_MODULES!r}:",
        "    importlib.import_module('svtpu_torch.evaluation.' + name)",
        "from svtpu_torch.evaluation.projections import project",
        "try:",
        "    project([[0.0, 1.0]], 'pca')",
        "except ImportError:",
        "    print('imported; pca needs sklearn')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported; pca needs sklearn"
