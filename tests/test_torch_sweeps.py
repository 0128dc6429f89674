"""The port's sweeps on the CPU: the counterparts of the 9 tests of
``tests/test_sweeps.py`` (the mocked-wandb branch and resume included, at
16x16), parity with ``svtpu``'s spaces, sampler and trial configs, and the
CLI's ``sweep`` feeding ``eval-tradeoff --sweep-dir``."""
import dataclasses
import json
import sys
import types

import numpy as np
import pytest

from svtpu.config import VideoMeta as JaxVideoMeta
from svtpu.sweeps import runner as jrunner
from svtpu.sweeps import spaces as jspaces
from svtpu_torch import cli
from svtpu_torch.config import VideoMeta
from svtpu_torch.sweeps import runner
from svtpu_torch.sweeps.spaces import (CONTRASTIVE_P_SPACE, CONTRASTIVE_SPACE,
                                       CONTRASTIVE_Z_SPACE, METRIC, SPACES,
                                       TRIPLET_SPACE, sample, to_wandb_config)

CPU = "cpu"


class ArrayStore:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.array = rng.integers(0, 255, (48, 16, 16, 3), dtype=np.uint8)

    @property
    def item_shape(self):
        return self.array.shape[1:]

    def gather(self, idx):
        return self.array[np.asarray(idx)]


META = VideoMeta("t", flags=(16, 32), last_frame=47, grey_out=0)
TINY = {"latent_dim": ("const", 6), "batch_size": ("const", 4),
        "num_epochs": ("const", 1)}


def _tiny(monkeypatch, variant):
    monkeypatch.setitem(runner.SPACES, variant,
                        dict(runner.SPACES[variant], **TINY))


def test_sample_respects_bounds():
    rng = np.random.default_rng(0)
    for _ in range(20):
        c = sample(CONTRASTIVE_SPACE, rng)
        assert 1e-5 <= c["learning_rate"] <= 1e-2
        assert c["batch_size"] in (16, 32, 64)
        assert c["latent_dim"] in (25, 50, 75, 100)
        assert 1.0 <= c["init_temperature"] <= 5.0
        assert 550 <= c["num_temp_updates"] <= 1100
        assert c["bernoulli_p"] == 0.1
        assert c["objective"] == "contrastive"


def test_triplet_space_differences():
    c = sample(TRIPLET_SPACE, np.random.default_rng(1))
    assert 0.3 <= c["bernoulli_p"] <= 0.7
    assert 0.01 <= c["alpha"] <= 1.0
    assert c["num_epochs"] == 30
    assert METRIC["triplet"] == ("best_val_loss", "minimize")


def test_contrastive_z_space():
    c = sample(CONTRASTIVE_Z_SPACE, np.random.default_rng(2))
    assert c["contrast_on"] == "z"
    assert c["select_by"] == "combined"
    assert 0.5 <= c["margin"] <= 4.0
    assert 0.02 <= c["beta_kl"] <= 1.0
    assert METRIC["contrastive_z"] == ("best_combined_score", "maximize")
    assert "contrastive_z" in SPACES


def test_contrastive_p_space():
    c = sample(CONTRASTIVE_P_SPACE, np.random.default_rng(3))
    assert c["contrast_on"] == "p"
    assert c["select_by"] == "combined"
    assert METRIC["contrastive_p"] == ("best_combined_score", "maximize")
    assert "contrastive_p" in SPACES


def test_wandb_config_shape():
    cfg = to_wandb_config(CONTRASTIVE_SPACE, METRIC["contrastive"])
    assert cfg["method"] == "bayes"
    assert cfg["metric"] == {"name": "best_consistency_score",
                             "goal": "maximize"}
    assert cfg["parameters"]["learning_rate"]["distribution"] == \
        "log_uniform_values"
    assert cfg["parameters"]["batch_size"]["values"] == [16, 32, 64]
    assert cfg["parameters"]["num_epochs"]["value"] == 100


def test_local_sweep_end_to_end(tmp_path, monkeypatch):
    """One-trial local random search over a tiny synthetic video."""
    _tiny(monkeypatch, "contrastive")
    res = runner.run_sweep("contrastive", ArrayStore(), META, count=1,
                           seed=0, save_dir=str(tmp_path), use_wandb=False,
                           device=CPU)
    assert res["metric"] == "best_consistency_score"
    assert len(res["trials"]) == 1
    assert (tmp_path / "sweep_results.json").exists()
    assert (tmp_path / "best_model_local_0" / "best.pt").exists()
    assert (tmp_path / "best_model_local_0" / "best.json").exists()


def test_local_sweep_contrastive_z(tmp_path, monkeypatch):
    """contrastive_z maps to the contrastive model, trains with
    contrast_on='z', and optimizes the combined score."""
    _tiny(monkeypatch, "contrastive_z")
    res = runner.run_sweep("contrastive_z", ArrayStore(), META, count=1,
                           seed=0, save_dir=str(tmp_path), use_wandb=False,
                           device=CPU)
    assert res["metric"] == "best_combined_score"
    t = res["trials"][0]
    assert t["config"]["contrast_on"] == "z"
    assert np.isfinite(t["best_combined_score"])


def test_wandb_sweep_branch_with_mock(tmp_path, monkeypatch):
    """The W&B branch against a mocked ``wandb`` module that plays the sweep
    controller: it samples each trial's config from the submitted sweep
    ``parameters``, so ``run_sweep(use_wandb=True)`` trains for real."""
    calls = {"sweep": [], "init": 0, "log": [], "save": [], "finish": 0}
    rng = np.random.default_rng(7)

    def sample_params(params):
        cfg = {}
        for name, spec in params.items():
            if "value" in spec:
                cfg[name] = spec["value"]
            elif "values" in spec:
                cfg[name] = spec["values"][int(rng.integers(
                    len(spec["values"])))]
            elif spec.get("distribution") == "log_uniform_values":
                lo, hi = np.log(spec["min"]), np.log(spec["max"])
                cfg[name] = float(np.exp(rng.uniform(lo, hi)))
            elif spec.get("distribution") == "int_uniform":
                cfg[name] = int(rng.integers(spec["min"], spec["max"] + 1))
            else:
                cfg[name] = float(rng.uniform(spec["min"], spec["max"]))
        return cfg

    class FakeRun:
        def __init__(self, config, idx):
            self.config, self.name, self.id = config, f"mock_{idx}", str(idx)

        def finish(self):
            calls["finish"] += 1

    def fake_init():
        run = FakeRun(sample_params(calls["sweep"][-1][0]["parameters"]),
                      calls["init"])
        calls["init"] += 1
        return run

    def fake_agent(sweep_id, function=None, count=1):
        assert sweep_id == "sweep_123"
        for _ in range(count):
            function()

    mock = types.ModuleType("wandb")
    mock.sweep = lambda cfg, project=None: (
        calls["sweep"].append((cfg, project)) or "sweep_123")
    mock.init = fake_init
    mock.agent = fake_agent
    mock.log = lambda d: calls["log"].append(d)
    mock.save = lambda p: calls["save"].append(p)
    monkeypatch.setitem(sys.modules, "wandb", mock)
    _tiny(monkeypatch, "contrastive")

    res = runner.run_sweep("contrastive", ArrayStore(), META, count=2,
                           seed=0, save_dir=str(tmp_path), use_wandb=True,
                           device=CPU)
    assert res == {"sweep_id": "sweep_123"}
    sweep_cfg, project = calls["sweep"][0]
    assert project == "svtpu_contrastive_sweep"
    assert sweep_cfg == jspaces.to_wandb_config(
        runner.SPACES["contrastive"], METRIC["contrastive"])
    assert calls["init"] == 2 and calls["finish"] == 2
    assert len(calls["log"]) == 2
    assert all(np.isfinite(d["best_consistency_score"])
               for d in calls["log"])
    assert len(calls["save"]) == 2
    assert (tmp_path / "best_model_mock_0" / "best.pt").exists()


def test_local_sweep_resume(tmp_path, monkeypatch):
    """A re-run over the same save_dir reuses the recorded summaries
    instead of retraining; a record whose config differs retrains."""
    _tiny(monkeypatch, "contrastive")
    first = runner.run_sweep("contrastive", ArrayStore(), META, count=1,
                             seed=5, save_dir=str(tmp_path),
                             use_wandb=False, device=CPU)

    def boom(*a, **k):
        raise AssertionError("resumed sweep must not retrain")

    with monkeypatch.context() as m:
        m.setattr(runner, "train_with_config", boom)
        second = runner.run_sweep("contrastive", ArrayStore(), META,
                                  count=1, seed=5, save_dir=str(tmp_path),
                                  use_wandb=False, device=CPU)
    assert second["best"] == first["best"]
    assert second["best_config"] == first["best_config"]

    record = tmp_path / "local_0_config.json"
    rec = json.loads(record.read_text())
    rec["config"]["margin"] += 1.0
    record.write_text(json.dumps(rec))
    ran = []
    monkeypatch.setattr(runner, "train_with_config", lambda *a, **k: (
        ran.append(a[0]) or {"best_consistency_score": 0.5}))
    runner.run_sweep("contrastive", ArrayStore(), META, count=1, seed=5,
                     save_dir=str(tmp_path), use_wandb=False, device=CPU)
    assert ran == [first["best_config"]]


@pytest.mark.parametrize("seed", range(10))
def test_sample_equals_svtpus(seed):
    """The same ``default_rng(seed)`` draws the same configs over all six
    spaces, and ``to_wandb_config`` gives the same dicts."""
    assert set(SPACES) == set(jspaces.SPACES) and METRIC == jspaces.METRIC
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for name in sorted(SPACES):
        assert SPACES[name] == jspaces.SPACES[name]
        for _ in range(3):
            assert sample(SPACES[name], rng) == jspaces.sample(
                jspaces.SPACES[name], jrng), name
        assert to_wandb_config(SPACES[name], METRIC[name]) == \
            jspaces.to_wandb_config(jspaces.SPACES[name],
                                    jspaces.METRIC[name])


class _Recorder:
    """A ``Trainer`` stand-in that records its arguments and returns a
    fixed history."""

    calls = []

    def __init__(self, mcfg, tcfg, store, splits, flags, **kw):
        _Recorder.calls.append((mcfg, tcfg, splits))

    def train(self, num_epochs=None, save_path=None):
        return {"val_losses": [{"consistency_score": 0.5, "total_loss": 1.0,
                                "combined_score": 0.25,
                                "state_separation": 2.0}]}


@pytest.mark.parametrize("variant", sorted(SPACES))
def test_train_with_config_builds_svtpus_configs(variant, monkeypatch):
    """Both runners' trials, with each ``Trainer`` replaced by a recorder,
    build equal model and train configs, field for field where both
    dataclasses have the field, and the same splits and summary."""
    cfg = sample(SPACES[variant], np.random.default_rng(11))
    store = ArrayStore()
    jmeta = JaxVideoMeta("t", flags=(16, 32), last_frame=47, grey_out=0)
    _Recorder.calls = []
    monkeypatch.setattr(runner, "Trainer", _Recorder)
    monkeypatch.setattr(jrunner, "Trainer", _Recorder)
    ours = runner.train_with_config(cfg, variant, store, META, device=CPU)
    theirs = jrunner.train_with_config(cfg, variant, store, jmeta)
    (m, t, s), (jm, jt, js) = _Recorder.calls
    for a, b in ((m, jm), (t, jt)):
        fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        common = set(fa) & set(fb)
        assert len(common) > 10
        assert {k: fa[k] for k in common} == {k: fb[k] for k in common}
    assert [list(x) for x in s.train] == [list(x) for x in js.train]
    assert {k: v for k, v in ours.items() if k != "history"} == \
        {k: v for k, v in theirs.items() if k != "history"}


def test_cli_sweep_feeds_eval_tradeoff(tmp_path, capsys):
    """``sweep --device cpu`` as a user runs it (one trial, one epoch), then
    ``eval-tradeoff --sweep-dir`` on its directory, then the same sweep
    again, which resumes without training."""
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(48):
        arr = np.clip(np.full((16, 16, 3), 60 * (i // 16), np.int64)
                      + rng.integers(0, 40, (16, 16, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(frames / f"{i:010d}.jpg")
    video = ["--video", "tiny", "--flags", "16", "32", "--last-frame", "47",
             "--grey-out", "0", "--resolution", "16", "--frames-dir",
             str(frames), "--device", "cpu"]
    sweep = tmp_path / "sweep"
    argv = ["sweep", *video, "--variant", "contrastive_p", "--count", "1",
            "--epochs", "1", "--no-wandb", "--seed", "0", "--save-dir",
            str(sweep)]
    cli.main(argv)
    assert "best best_combined_score:" in capsys.readouterr().out
    assert (sweep / "best_model_local_0" / "best.pt").exists()
    out = tmp_path / "out"
    cli.main(["eval-tradeoff", *video, "--sweep-dir", str(sweep),
              "--out-dir", str(out)])
    lines = (out / "tradeoff.csv").read_text().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("local_0,")
    cli.main(argv)
    assert "[trial 0/1] resumed" in capsys.readouterr().out
