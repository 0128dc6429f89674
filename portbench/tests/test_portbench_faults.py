"""A run of each cell with the timed path broken underneath: the harness
past its look for a card, at a tiny size on the CPU, must report
``correct`` false, once for each fault the cell can have. And on the card,
the control (the reference one precision below, in the program's place)
at the cell's own size must fail too."""
import time

import pytest
import torch

from portbench.run import run_cell

TINY_ENCODE = {"traffic": {"batch": 4, "frame_hw": [48, 80], "batches": 3,
                           "greedy_every": 2, "check_greedy": 3,
                           "check_noisy": 2}}
# float32, so that a sound run at this size reads far under the cell's
# limits (bf16 rounding at 32x32 is not what they were set from).
TINY_TRAIN = {"config": {"model": {"input_hw": [32, 32],
                                   "compute_dtype": "float32",
                                   "pallas_trunk": False,
                                   "pallas_sampler": False},
                         "train": {"batch_size": 4}},
              "traffic": {"warm_epochs": 3}}
SEED = 2 ** 31 + 12345


def encode(**kw):
    return run_cell("pixel-encode.hd64", SEED, 0.5, False,
                    time.perf_counter(), device="cpu", sizes=TINY_ENCODE,
                    **kw)


def train(**kw):
    return run_cell("flagship-train", SEED, 0.5, False, time.perf_counter(),
                    device="cpu", sizes=TINY_TRAIN, **kw)


def test_sound_runs_are_correct():
    assert encode()["correct"]
    assert train()["correct"]


def test_encode_answer_altered_where_produced(monkeypatch):
    from svtpu_torch.pipeline import VideoSymbolPipeline

    codes = VideoSymbolPipeline._codes

    def altered(self, *a, **k):
        z = codes(self, *a, **k).clone()
        z[0] = 1 - z[0]                    # every bit of the first frame
        return z

    monkeypatch.setattr(VideoSymbolPipeline, "_codes", altered)
    assert not encode()["correct"]


def test_encode_half_the_batch_left_out(monkeypatch):
    from svtpu_torch.pipeline import VideoSymbolPipeline

    codes = VideoSymbolPipeline._codes

    def half(self, inputs, *a, **k):
        (x,) = inputs
        z = codes(self, (x[:len(x) // 2],), *a, **k)
        return torch.cat([z, z])

    monkeypatch.setattr(VideoSymbolPipeline, "_codes", half)
    assert not encode()["correct"]


def test_encode_noisy_codes_drawn_without_noise(monkeypatch):
    """Only the noisy pipeline's answers are altered: its bits come out
    as the greedy ones would."""
    from svtpu_torch.pipeline import VideoSymbolPipeline

    codes = VideoSymbolPipeline._codes

    def greedy(self, inputs, temperature, noise_ratio, generator):
        return codes(self, inputs, temperature, 0.0 * noise_ratio, generator)

    monkeypatch.setattr(VideoSymbolPipeline, "_codes", greedy)
    r = encode()
    assert not r["correct"]
    flip, gap = r["checks"]["flip_z"], r["checks"]["code_gap"]
    assert flip["value"] > flip["limit"]
    assert gap["value"] <= gap["limit"]


TINY_PERCEP = {"config": {"sd": {"ch": 32, "resize_wh": [128, 64]},
                          "model": {"input_hw": [8, 16],
                                    "conv_features": [32, 32, 32]}},
               "traffic": {"batch": 2, "frame_hw": [64, 128],
                           "sd_hw": [64, 128], "batches": 2,
                           "greedy_every": 3, "check_greedy": 2,
                           "check_noisy": 3}}


def percep():
    return run_cell("percep-encode.sd8", SEED, 1.0, False,
                    time.perf_counter(), device="cpu", sizes=TINY_PERCEP)


def test_percep_sound_and_noisy_latents_drawn_without_noise(monkeypatch):
    """The perceptual path's noisy requests: sound, they pass; with the
    posterior's sample replaced by its mode in them alone, they fail."""
    from svtpu_torch.models.autoencoder_kl import DiagonalGaussian

    r = percep()
    assert r["correct"], r["checks"]
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        lambda self, generator: self.mean)
    r = percep()
    assert not r["correct"]
    dev = r["checks"]["posterior_dev"]
    assert dev["value"] > dev["limit"]
    for name in ("latent_err", "code_gap", "flip_z"):
        assert r["checks"][name]["value"] <= r["checks"][name]["limit"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from svtpu_torch.training.trainer import Trainer

    body = Trainer._step_body

    def unchanged(self, model, optimizer, batch):
        before = [p.detach().clone() for p in model.parameters()]
        out = body(self, model, optimizer, batch)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(Trainer, "_step_body", unchanged)
    r = train()
    assert not r["correct"]
    assert r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(monkeypatch):
    import svtpu_torch.training.trainer as trainer

    objective = trainer.pair_objective

    def half(model, cfg, batch, *a, **k):
        return objective(model, cfg, batch[:len(batch) // 2], *a, **k)

    monkeypatch.setattr(trainer, "pair_objective", half)
    assert not train()["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("pixel-encode.hd64", 2.0),
                                          ("flagship-train", 1.0),
                                          ("percep-encode.sd8", 4.0)])
def test_control_fails_on_the_card(cell, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (SEED, SEED + 1, SEED + 2):
        r = run_cell(cell, seed, seconds, False, time.perf_counter(),
                     control=True)
        assert not r["correct"], r["checks"]


def four_ranks(mode: str) -> dict:
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", str(here / "_rank.py"), mode],
        capture_output=True, text=True, timeout=600, cwd=here.parents[1],
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_four_ranks_sound_and_without_the_exchange():
    """Four gloo ranks on the CPU: a sound run is correct; with the
    gradient exchange between the ranks left out it is not."""
    assert four_ranks("sound")["correct"]
    r = four_ranks("no_exchange")
    assert not r["correct"], r["checks"]
