"""Parity of the port's evaluation with ``svtpu``'s on the CPU: both start
from ``svtpu``'s init of the tiny model carried across by
``from_jax_params`` and see ``tests/test_evaluation.py``'s 30 frames.

Noisy codes cannot match draw for draw (threefry against Philox or the
Mersenne Twister), but the contrastive variant scales its logistic noise by
the noise ratio, so at ``noise_ratio=0.0`` "noise on" gives the noise-off
codes in both packages, bit for bit; the protocols are compared there.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu.evaluation import bitmatch as jbitmatch
from svtpu.evaluation import consistency as jconsistency
from svtpu.evaluation import hamming as jhamming
from svtpu.evaluation import linear_probe as jprobe
from svtpu.evaluation import projections as jprojections
from svtpu.evaluation import tradeoff as jtradeoff
from svtpu.evaluation.common import RBVAEBundle as JaxBundle
from svtpu.evaluation.umap_min import umap_embed as jax_umap_embed
from svtpu.ops.image import add_occlusion as jax_add_occlusion
from svtpu_torch.data.segments import split_segments
from svtpu_torch.evaluation import (bitmatch, consistency, hamming,
                                   linear_probe, projections, tradeoff)
from svtpu_torch.evaluation.common import RBVAEBundle
from svtpu_torch.evaluation.umap_min import umap_embed
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.image import add_gaussian_noise, occlude
from svtpu_torch.training.checkpoints import BestCheckpointer

from _torch_port import ArrayStore, eval_frames, eval_model

IDX = list(range(30))
FLAGS = [10, 20]


@pytest.fixture(scope="module")
def bundles():
    """``(svtpu's bundle, the port's bundle)`` on the same weights."""
    jcfg, params, tcfg, sd = eval_model()
    return (JaxBundle(cfg=jcfg, params=params, name="m"),
            RBVAEBundle(tcfg, sd, name="m", device="cpu"))


@pytest.fixture(scope="module")
def frames():
    return eval_frames()


@pytest.mark.parametrize("noise", ["off", "on at noise ratio 0"])
def test_encode_codes_bit_identical(bundles, frames, noise):
    """30 frames in chunks of 8 (the last one padded), f32: the port's
    codes equal svtpu's bit for bit; noise on at ratio 0 gives the noise-off
    codes in both packages."""
    jb, tb = bundles
    kw = dict(noise=noise != "off", noise_ratio=0.0, chunk=8, seed=5)
    ref = jb.encode(frames, noise=False, chunk=8)
    np.testing.assert_array_equal(jb.encode(frames, **kw), ref)
    got = tb.encode(frames, **kw)
    assert got.shape == (30, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_hamming_matches_svtpu(bundles, frames):
    jb, tb = bundles
    ref = jhamming.evaluate_hamming(jb, frames, IDX, FLAGS, noise_ratio=0.0)
    got = hamming.evaluate_hamming(tb, frames, IDX, FLAGS, noise_ratio=0.0)
    np.testing.assert_array_equal(got["modal_codes"], ref["modal_codes"])
    np.testing.assert_array_equal(got["hamming"], ref["hamming"])
    assert got["mean_hamming"] == ref["mean_hamming"]


def _numpy_perturbation(frames01, kind, seed):
    """A deterministic perturbation both packages can run."""
    gain = 0.9 + 0.01 * (seed % 7) + (0.05 if kind == "noise" else 0.0)
    return np.clip(frames01 * gain + 0.02, 0, 1).astype(np.float32)


@pytest.mark.parametrize("case", ["clean", "numpy perturb_fn",
                                  "perturb_embeddings clean"])
def test_consistency_trials_match_svtpu(bundles, frames, case):
    """Every trial's score equal to svtpu's at noise ratio 0."""
    jb, tb = bundles
    kinds, jfn, tfn = {
        "clean": (("clean",), jconsistency.perturb_frames, None),
        "numpy perturb_fn": (("noise", "occlusion"), _numpy_perturbation,
                             _numpy_perturbation),
        "perturb_embeddings clean": (
            ("clean",), jconsistency.perturb_embeddings,
            functools.partial(consistency.perturb_embeddings, device="cpu")),
    }[case]
    kw = dict(num_trials=2, noise_ratio=0.0, perturbations=kinds)
    ref = jconsistency.evaluate_consistency(jb, frames, IDX, FLAGS,
                                            perturb_fn=jfn, **kw)
    got = consistency.evaluate_consistency(tb, frames, IDX, FLAGS,
                                           perturb_fn=tfn, **kw)
    assert [(r.perturbation, r.trials) for r in got] == \
        [(r.perturbation, r.trials) for r in ref]


@pytest.mark.parametrize("shape, coverage", [((2, 16, 20, 3), 0.25),
                                             ((1, 32, 32, 3), 0.2)])
def test_occlusion_at_svtpus_corner(shape, coverage):
    """The port's square at the corner svtpu drew equals svtpu's output
    (0 abs error)."""
    x = np.random.default_rng(1).random(shape, np.float32)
    ref = np.asarray(jax_add_occlusion(jnp.asarray(x), jax.random.key(4),
                                       coverage))
    changed = (ref != x).any(-1)
    assert changed.all(0).sum() == changed[0].sum() > 0
    top, left = np.argwhere(changed[0]).min(0)
    side = int((coverage * shape[1] * shape[2]) ** 0.5)
    got = occlude(torch.from_numpy(x), int(top), int(left), side, side, 0.5)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gaussian_noise_statistics():
    """On 0.5 grey: the output lies in [0, 1], and the noise's mean and std
    are within 5% of 0.1 of 0 and of 0.1."""
    x = torch.full((4, 64, 64, 3), 0.5)
    out = add_gaussian_noise(x, torch.Generator().manual_seed(2), 0.1)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    d = out - x
    assert abs(float(d.mean())) <= 0.005
    assert abs(float(d.std()) - 0.1) <= 0.005


@pytest.mark.parametrize("shape, coverage", [((2, 88, 160, 4), 0.2),
                                             ((1, 11, 20, 4), 0.2),
                                             ((1, 3, 5, 2), 0.05)])
def test_embedding_occlusion_square_matches_svtpu(shape, coverage):
    """perturb_embeddings zeroes a square of svtpu's size."""
    emb = 1.0 + np.random.default_rng(3).random(shape, np.float32)

    def square(out):
        zero = (out == 0).all(-1)[0]
        rows, cols = np.nonzero(zero)
        return rows.max() - rows.min() + 1, cols.max() - cols.min() + 1

    ref = jconsistency.perturb_embeddings(emb, "occlusion", 6,
                                          occlusion_coverage=coverage)
    got = consistency.perturb_embeddings(emb, "occlusion", 6,
                                         occlusion_coverage=coverage,
                                         device="cpu")
    assert square(got) == square(ref) == consistency.embedding_square(
        shape[1], shape[2], coverage)
    assert (got == 0).all(-1).sum() == (ref == 0).all(-1).sum()


def test_tradeoff_point_matches_svtpu(bundles, frames):
    jb, tb = bundles
    ref = jtradeoff.evaluate_checkpoint(jb, frames, IDX, FLAGS,
                                        noise_ratio=0.0)
    got = tradeoff.evaluate_checkpoint(tb, frames, IDX, FLAGS,
                                       noise_ratio=0.0)
    assert got == ref


def test_sweep_dir_and_standalone_checkpoints(bundles, frames, tmp_path):
    """Checkpoint dirs written by the port's BestCheckpointer, a sweep's
    ``<run>_config.json`` beside them (one run without a checkpoint,
    skipped): the points equal svtpu's evaluate_checkpoint on the same
    split."""
    jb, _ = bundles
    _, _, _, sd = eval_model()
    store = ArrayStore(frames)
    splits = split_segments(((0, 10), (10, 20), (20, 30)), 0.2, 0.3)
    val = splits.flat("val")
    ref = jtradeoff.evaluate_checkpoint(jb, frames[val], val, FLAGS,
                                        noise_ratio=0.0)
    BestCheckpointer(tmp_path / "best_model_local_1").save(
        {"model": sd}, epoch=3, metric=0.7)
    for run in ("local_1", "local_2"):
        (tmp_path / f"{run}_config.json").write_text(json.dumps(
            {"config": {"latent_dim": 6, "noise_ratio": 0.0}}))
    points = tradeoff.evaluate_sweep_dir(tmp_path, store, splits, FLAGS,
                                         device="cpu")
    assert [p.run for p in points] == ["local_1"]
    p = points[0]
    assert (p.consistency, p.separation, p.det_consistency) == ref
    solo = tradeoff.evaluate_standalone(
        "solo", tmp_path / "best_model_local_1", store, splits, FLAGS,
        latent_dim=6, noise_ratio=0.0, device="cpu")
    assert (solo.consistency, solo.separation, solo.det_consistency) == ref
    assert solo.config["epoch"] == 3 and solo.config["latent_dim"] == 6
    tradeoff.write_csv(points + [solo], tmp_path / "t.csv")
    assert (tmp_path / "t.csv").read_text().startswith(
        "run,consistency,det_consistency,separation_bits,")
    tradeoff.plot_tradeoff(points + [solo], tmp_path / "t.png")
    assert (tmp_path / "t.png").exists()


def test_pareto_front_matches_svtpu():
    rng = np.random.default_rng(5)
    values = [(float(c), float(s)) for c, s in zip(
        rng.choice([0.2, 0.5, 0.8, 0.9], 14), rng.choice([1, 2, 3, 5], 14))]
    jpts = [jtradeoff.TradeoffPoint(f"r{i}", c, s, 0.0, {})
            for i, (c, s) in enumerate(values)]
    tpts = [tradeoff.TradeoffPoint(f"r{i}", c, s, 0.0, {})
            for i, (c, s) in enumerate(values)]
    ref = [p.run for p in jtradeoff.pareto_front(jpts)]
    assert [p.run for p in tradeoff.pareto_front(tpts)] == ref
    assert 0 < len(ref) < len(values)


def test_bit_match_matches_svtpu():
    rng = np.random.default_rng(6)
    a = rng.random((40, 25), np.float32)
    b = np.where(rng.random((40, 25)) < 0.05, 1 - a, a)
    b[:20] = a[:20]
    assert bitmatch.bit_match(a, b) == jbitmatch.bit_match(a, b)
    with pytest.raises(ValueError):
        bitmatch.bit_match(a, b[:, :5])


def test_codes_from_a_torch_checkpoint_match_svtpu(frames):
    """A state dict of the port's model with both LSTM biases non-zero,
    through the port (loaded as it is) and through svtpu's converter
    (which folds the biases): 100% of bits match."""
    jcfg, _, tcfg, _ = eval_model()
    model = Seq2SeqBinaryVAE(tcfg, device="cpu",
                             generator=torch.Generator().manual_seed(7))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(8)
    for k, v in sd.items():
        if "bias_hh" in k:
            v.copy_(torch.rand(v.shape, generator=g) * 0.4 - 0.2)
    assert all(bool(v.abs().min() > 0) for k, v in sd.items()
               if ".bias_" in k)
    got = bitmatch.codes_from_torch_checkpoint(sd, tcfg, frames,
                                               device="cpu")
    ref = jbitmatch.codes_from_torch_checkpoint(sd, jcfg, frames)
    m = bitmatch.bit_match(got, ref)
    assert m["bit_match_pct"] == 100.0 and m["n_frames"] == 30


def test_hidden_states_match_svtpu(bundles, frames):
    jb, tb = bundles
    ref = jprobe.hidden_states(jb, frames)
    got = linear_probe.hidden_states(tb, frames)
    assert got.shape == ref.shape == (30, 6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_linear_probe_metrics_match_svtpu(bundles, frames):
    jb, tb = bundles
    ref = jprobe.evaluate_linear_probe(jb, frames)
    got = linear_probe.evaluate_linear_probe(tb, frames)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_umap_embed_equals_svtpus():
    x = np.random.default_rng(9).random((50, 8))
    np.testing.assert_array_equal(
        umap_embed(x, n_neighbors=8, n_epochs=60, seed=3),
        jax_umap_embed(x, n_neighbors=8, n_epochs=60, seed=3))


def test_soft_codes_and_pca_match_svtpu(bundles, frames):
    """Soft codes at noise ratio 0 within 1e-6; their PCA coordinates equal
    up to a sign per axis."""
    jb, tb = bundles
    ref = jprojections.soft_codes(jb, frames, noise_ratio=0.0)
    got = projections.soft_codes(tb, frames, noise_ratio=0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    pr = projections.project(ref, "pca")
    pg = projections.project(got, "pca")
    sign = np.sign((pr * pg).sum(0))
    np.testing.assert_allclose(pg * sign, pr, rtol=0, atol=1e-5)
