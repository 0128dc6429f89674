"""The port's command line on the CPU (``--device cpu`` throughout): the
counterparts of ``tests/test_cli_eval.py`` other than
``test_train_multi_video`` (in ``tests/test_torch_multi.py``), ``encode``
and ``embed`` against ``svtpu.cli`` on shared weights, and the guards: no
card and no ``--device`` exits, eval commands without matplotlib, an
import that pulls in neither matplotlib nor sklearn nor PIL, and
``download-weights`` against a blocked and a fake ``huggingface_hub`` (no
test reaches the network). ``sweep`` is in ``tests/test_torch_sweeps.py``. The video commands are in
``tests/test_torch_video.py``."""
import functools
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svtpu import cli as jcli
from svtpu_torch import cli
from svtpu_torch.config import rbvae_variant
from svtpu_torch.data.symbols import SymbolStore
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.training.checkpoints import BestCheckpointer

from _torch_port import seeded_ae_params

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """48 tiny jpgs in the %010d.jpg layout + a 3-state flag set."""
    from PIL import Image

    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(48):
        arr = np.full((32, 32, 3), 40 * (i // 16), np.uint8)
        arr = np.clip(arr + rng.integers(0, 40, arr.size)
                      .reshape(arr.shape), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{i:010d}.jpg")
    return d


def _save_ckpt(tmp_path, name, seed, latent=6, sd=None):
    """A port checkpoint directory as ``Trainer.train`` writes it, of a
    fresh model drawn from ``seed`` (or of ``sd``)."""
    if sd is None:
        cfg = rbvae_variant("contrastive", latent_dim=latent,
                            input_hw=(32, 32))
        sd = Seq2SeqBinaryVAE(cfg, device="cpu", generator=torch.Generator()
                              .manual_seed(seed)).state_dict()
    BestCheckpointer(tmp_path / name).save({"model": sd, "optimizer": {}},
                                           epoch=0, metric=0.0)
    return str(tmp_path / name)


VIDEO = ["--video", "tiny", "--flags", "16", "32", "--last-frame", "47",
         "--grey-out", "0", "--resolution", "32"]


def test_eval_consistency_side_by_side(video_dir, tmp_path):
    a = _save_ckpt(tmp_path, "a", 0)
    b = _save_ckpt(tmp_path, "b", 1)
    out = tmp_path / "out"
    cli.main(["eval-consistency", *VIDEO, *CPU,
              "--frames-dir", str(video_dir),
              "--model", f"ckpt={a},name=pixels,latent=6",
              "--model", f"ckpt={b},name=other,latent=6",
              "--trials", "2", "--out-dir", str(out)])
    csv = (out / "consistency.csv").read_text()
    assert "pixels," in csv and "other," in csv
    # 2 models x 3 perturbations + header
    assert len(csv.strip().splitlines()) == 7
    assert (out / "consistency.png").exists()


def test_eval_hamming_side_by_side(video_dir, tmp_path):
    a = _save_ckpt(tmp_path, "a2", 2)
    b = _save_ckpt(tmp_path, "b2", 3)
    out = tmp_path / "out2"
    cli.main(["eval-hamming", *VIDEO, *CPU,
              "--frames-dir", str(video_dir),
              "--model", f"ckpt={a},name=pixels,latent=6",
              "--model", f"ckpt={b},name=other,latent=6",
              "--out-dir", str(out)])
    csv = (out / "hamming.csv").read_text()
    assert "pixels," in csv and "other," in csv
    assert (out / "hamming.png").exists()


def test_eval_single_model_unchanged(video_dir, tmp_path):
    """The single ``--ckpt`` interface."""
    a = _save_ckpt(tmp_path, "a3", 4)
    out = tmp_path / "out3"
    cli.main(["eval-consistency", *VIDEO, *CPU,
              "--frames-dir", str(video_dir),
              "--ckpt", a, "--latent-dim", "6",
              "--trials", "1", "--out-dir", str(out)])
    assert (out / "consistency.csv").exists()


def test_model_spec_errors(video_dir, tmp_path):
    with pytest.raises(SystemExit, match="ckpt"):
        cli.main(["eval-hamming", *VIDEO, *CPU,
                  "--frames-dir", str(video_dir),
                  "--model", "name=x", "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="unknown --model keys"):
        cli.main(["eval-hamming", *VIDEO, *CPU,
                  "--frames-dir", str(video_dir),
                  "--model", "ckpt=x,bogus=1", "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--ckpt or at least one"):
        cli.main(["eval-hamming", *VIDEO, *CPU,
                  "--frames-dir", str(video_dir),
                  "--out-dir", str(tmp_path)])


def _sweep_dir(tmp_path):
    """Two sweep checkpoints and their config jsons."""
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for i in range(2):
        _save_ckpt(sweep, f"best_model_local_{i}", seed=10 + i)
        (sweep / f"local_{i}_config.json").write_text(json.dumps(
            {"config": {"latent_dim": 6, "noise_ratio": 0.1,
                        "margin": 1.0 + i}}))
    return sweep


def test_eval_tradeoff(video_dir, tmp_path):
    """eval-tradeoff over a sweep dir: two checkpoints + their config
    jsons -> joint CSV + scatter chart + pareto front."""
    sweep = _sweep_dir(tmp_path)
    out = tmp_path / "out_t"
    cli.main(["eval-tradeoff", *VIDEO, *CPU,
              "--frames-dir", str(video_dir),
              "--sweep-dir", str(sweep), "--out-dir", str(out)])
    lines = (out / "tradeoff.csv").read_text().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith(
        "run,consistency,det_consistency,separation_bits")
    assert (out / "tradeoff.png").exists()

    # Standalone checkpoints join the same chart via --extra.
    solo = _save_ckpt(tmp_path, "solo", seed=20)
    out2 = tmp_path / "out_t2"
    cli.main(["eval-tradeoff", *VIDEO, *CPU,
              "--frames-dir", str(video_dir),
              "--sweep-dir", str(sweep),
              "--extra", f"deep_run:{solo}:6:best",
              "--out-dir", str(out2)])
    csv2 = (out2 / "tradeoff.csv").read_text()
    assert "deep_run," in csv2
    assert len(csv2.strip().splitlines()) == 4


def test_pareto_front():
    from svtpu_torch.evaluation.tradeoff import TradeoffPoint, pareto_front

    pts = [TradeoffPoint("a", 0.9, 1.0, 0.9, {}),
           TradeoffPoint("b", 0.5, 3.0, 0.5, {}),
           TradeoffPoint("c", 0.4, 2.0, 0.4, {}),   # dominated by b
           TradeoffPoint("d", 0.9, 0.5, 0.9, {})]   # dominated by a
    assert [p.run for p in pareto_front(pts)] == ["a", "b"]


def test_train_preset_applies_and_explicit_flags_override(monkeypatch):
    """--preset flagship loads the preset-v2 recipe's defaults while
    explicit flags still win."""
    captured = {}
    monkeypatch.setattr(cli, "cmd_train",
                        lambda args: captured.update(vars(args)))
    cli.main(["train", "--preset", "flagship", "--video", "chinese_chess",
              "--frames-dir", "unused", "--epochs", "3", *CPU])
    assert captured["contrast_on"] == "p"
    assert captured["contextfree_contrast"] is True
    assert captured["margin"] == 3.5
    assert captured["final_temp"] == 0.2        # full anneal, no floor
    assert captured["l1_logits"] == 0.1         # the measured logit brake
    assert captured["restart_min_sep"] == 10.0  # strict basin check
    assert captured["eval_noise_ratio"] == 0.1
    assert captured["select_by"] == "combined"
    assert captured["restart_check_epoch"] == 250
    assert captured["epochs"] == 3          # explicit flag overrides preset
    assert captured["device"] == torch.device("cpu")

    captured.clear()
    cli.main(["train", "--preset", "flagship-v1", "--video",
              "chinese_chess", "--frames-dir", "unused", *CPU])
    assert captured["final_temp"] == 0.55
    assert captured["l1_logits"] == 0.0
    assert captured["restart_min_sep"] == 3.0


def test_train_preset_percep(monkeypatch):
    captured = {}
    monkeypatch.setattr(cli, "cmd_train",
                        lambda args: captured.update(vars(args)))
    cli.main(["train", "--preset=percep-flagship",
              "--video", "chinese_chess", "--embeddings", "unused", *CPU])
    assert captured["variant"] == "percep"
    assert captured["lstm_residual"] is True
    assert captured["anneal_rate"] == 3e-4


def test_train_preset_unknown():
    with pytest.raises(SystemExit):
        cli.main(["train", "--preset", "nope", "--video", "chinese_chess",
                  *CPU])


def test_train_presets_equal_svtpus():
    assert cli.TRAIN_PRESETS == jcli.TRAIN_PRESETS


def test_train_multi_video_bad_spec(tmp_path):
    with pytest.raises(SystemExit, match="NAME=FRAMES_DIR"):
        cli.main(["train", "--multi", "novideodir",
                  "--resolution", "32", "--epochs", "1", *CPU])


def test_cli_encode_roundtrip(tmp_path, video_dir):
    """The product operation end to end: train 1 epoch, encode the frame
    dir, load the SymbolStore back."""
    flags_file = tmp_path / "transition_flags.txt"
    flags_file.write_text("vid_a:\n[16, 32], last_frame = 47, grey_out = 2\n")
    ckpt = tmp_path / "enc_ckpt"
    cli.main(["train", "--video", "vid_a", "--flags-file", str(flags_file),
              "--frames-dir", str(video_dir), "--resolution", "32",
              "--latent-dim", "8", "--epochs", "1", "--batch-size", "4",
              "--save-path", str(ckpt), *CPU])
    out = tmp_path / "symbols.npz"
    cli.main(["encode", str(video_dir), "--ckpt", str(ckpt),
              "--latent-dim", "8", "--resolution", "32", "--out", str(out),
              "--video", "vid_a", "--flags-file", str(flags_file),
              "--batch", "16", *CPU])
    store = SymbolStore.load(out)
    assert len(store) == 48
    assert store.codes.shape == (48, 8)
    assert set(np.unique(store.codes)) <= {0, 1}
    assert store.labels is not None and store.labels.max() == 2

    # deterministic mode is reproducible
    for name in ("s2.npz", "s3.npz"):
        cli.main(["encode", str(video_dir), "--ckpt", str(ckpt),
                  "--latent-dim", "8", "--resolution", "32",
                  "--out", str(tmp_path / name), "--deterministic", *CPU])
    np.testing.assert_array_equal(
        SymbolStore.load(tmp_path / "s2.npz").codes,
        SymbolStore.load(tmp_path / "s3.npz").codes)


def _small_perceptual(monkeypatch, **kw):
    """Both packages' ``PerceptualConfig()`` shrunk to a tiny AE, as
    ``tests/test_cli_eval.py`` shrinks svtpu's (ch must stay a multiple of
    the AE's 32-group GroupNorm)."""
    import svtpu.config as jconfig

    import svtpu_torch.config as tconfig

    small = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, **kw)
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "PerceptualConfig", functools.partial(
            mod.PerceptualConfig, **small))
    return small


def test_cli_interpolate_random_ckpt(tmp_path, video_dir, monkeypatch):
    """``interpolate --ckpt random`` runs encode→slerp→decode on a seeded
    random init and writes the grid figure; the same seed gives the same
    figure."""
    _small_perceptual(monkeypatch, resize_wh=(32, 32))
    outs = [tmp_path / f"interp{i}.png" for i in range(2)]
    for out in outs:
        cli.main(["interpolate", str(video_dir / "0000000000.jpg"),
                  str(video_dir / "0000000047.jpg"), "--ckpt", "random",
                  "--steps", "3", "--out", str(out), *CPU])
    assert outs[0].exists() and outs[0].stat().st_size > 0
    assert outs[0].read_bytes() == outs[1].read_bytes()


def test_encode_matches_svtpu_cli_bit_for_bit(tmp_path, video_dir):
    """``encode --deterministic --dtype float32`` of both CLIs on one set of
    weights (svtpu's init, carried across by ``from_jax_params``): the same
    codes and labels, bit for bit."""
    from svtpu.config import rbvae_variant as jax_variant
    from svtpu.data.symbols import SymbolStore as JaxSymbolStore
    from svtpu.models.rbvae import Seq2SeqBinaryVAE as JaxRBVAE
    from svtpu.training.checkpoints import \
        BestCheckpointer as JaxCheckpointer

    from svtpu_torch.models.convert import from_jax_params

    jcfg = jax_variant("contrastive", latent_dim=8, input_hw=(32, 32))
    params = JaxRBVAE(jcfg).init({"params": jax.random.key(3)},
                                 jnp.zeros((1, 1, 32, 32, 3)), 1.0, False,
                                 deterministic=True)
    JaxCheckpointer(tmp_path / "jax_ckpt").save({"params": params},
                                                epoch=0, metric=0.0)
    _save_ckpt(tmp_path, "port_ckpt", 0, sd=from_jax_params(
        params, rbvae_variant("contrastive", 8, input_hw=(32, 32))))
    args = [str(video_dir), "--latent-dim", "8", "--resolution", "32",
            "--deterministic", "--dtype", "float32", "--batch", "48",
            *VIDEO]
    jcli.main(["encode", *args, "--ckpt", str(tmp_path / "jax_ckpt"),
               "--out", str(tmp_path / "ref.npz")])
    cli.main(["encode", *args, "--ckpt", str(tmp_path / "port_ckpt"),
              "--out", str(tmp_path / "got.npz"), *CPU])
    ref = JaxSymbolStore.load(tmp_path / "ref.npz")
    got = SymbolStore.load(tmp_path / "got.npz")
    assert got.codes.shape == (48, 8) and 0 < got.codes.mean() < 1
    np.testing.assert_array_equal(got.codes, ref.codes)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.frame_ids, ref.frame_ids)


def test_embed_matches_svtpu_cli(tmp_path, video_dir, monkeypatch):
    """``embed --deterministic`` of both CLIs on one SD-style checkpoint
    (``first_stage_model.*`` names, written by ``torch.save``): the same
    keys and shapes, latents within rtol 1e-3, atol 1e-4 (f32)."""
    import svtpu.config as jconfig

    import svtpu_torch.config as tconfig
    from svtpu_torch.perceptual.convert import PREFIX, from_jax_params

    _small_perceptual(monkeypatch, resize_wh=(64, 32),
                      compute_dtype="float32")
    sd = from_jax_params(seeded_ae_params(jconfig.PerceptualConfig(), 6),
                         tconfig.PerceptualConfig())
    ckpt = tmp_path / "sd.ckpt"
    torch.save({"state_dict": {PREFIX + k: v for k, v in sd.items()}}, ckpt)
    for main, name in ((jcli.main, "ref.npy"), (cli.main, "got.npy")):
        extra = CPU if main is cli.main else []
        main(["embed", str(video_dir), str(tmp_path / name), "--ckpt",
              str(ckpt), "--batch-size", "4", "--deterministic", *extra])
    ref, got = (np.load(tmp_path / n, allow_pickle=True).item()
                for n in ("ref.npy", "got.npy"))
    assert sorted(got) == sorted(ref) and len(got) == 48
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == ref[k].shape \
            == (1, 4, 16, 32)
        np.testing.assert_allclose(v, ref[k], rtol=1e-3, atol=1e-4)


def _eval_argv(cmd, video_dir, tmp_path):
    """One argv per eval command on a seeded checkpoint."""
    ckpt = _save_ckpt(tmp_path, "m", 7)
    out = ["--out-dir", str(tmp_path / "out")]
    if cmd == "eval-tradeoff":
        return [cmd, *VIDEO, "--frames-dir", str(video_dir),
                "--extra", f"m:{ckpt}:6", *out]
    return [cmd, *VIDEO, "--frames-dir", str(video_dir), "--ckpt", ckpt,
            "--latent-dim", "6", "--trials", "1", *out]


@pytest.mark.parametrize("cmd, results", [
    ("eval-consistency", "consistency.csv"),
    ("eval-hamming", "hamming.csv"),
    ("eval-tradeoff", "tradeoff.csv"),
    ("eval-projections", "contrastive_pca.csv"),
    ("eval-probe", None),
])
def test_eval_without_matplotlib(cmd, results, video_dir, tmp_path,
                                 monkeypatch, capsys):
    """With matplotlib not importable, each eval command writes its results
    and prints one line a chart it did not write, and returns normally."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli.main(_eval_argv(cmd, video_dir, tmp_path) + CPU)
    out = capsys.readouterr().out
    skipped = [ln for ln in out.splitlines()
               if ln.startswith("chart not written (matplotlib is not "
                                "installed)")]
    assert skipped and all(ln.endswith(".png") for ln in skipped)
    assert not list((tmp_path / "out").glob("*.png"))
    if results is not None:
        assert len((tmp_path / "out" / results).read_text()
                   .strip().splitlines()) > 1
    if cmd == "eval-probe":
        assert set(json.loads(out.splitlines()[0])) == {
            "r2", "mse", "mae", "explained_variance"}


MODEL_COMMANDS = {
    "encode": lambda d, t: ["encode", str(d), "--ckpt", str(t)],
    "train": lambda d, t: ["train", "--video", "chinese_chess",
                           "--frames-dir", str(d)],
    "sweep": lambda d, t: ["sweep", "--video", "chinese_chess",
                           "--frames-dir", str(d), "--no-wandb"],
    "embed": lambda d, t: ["embed", str(d), str(t / "e.npy"), "--ckpt",
                           str(t / "sd.ckpt")],
    "interpolate": lambda d, t: ["interpolate", "a.jpg", "b.jpg",
                                 "--ckpt", "random"],
    "eval-tradeoff": lambda d, t: ["eval-tradeoff", *VIDEO, "--extra",
                                   f"m:{t}:6"],
    **{c: (lambda d, t, c=c: [c, *VIDEO, "--frames-dir", str(d), "--ckpt",
                              str(t)])
       for c in ("eval-consistency", "eval-hamming", "eval-projections",
                 "eval-probe")},
}


@pytest.mark.parametrize("cmd", sorted(MODEL_COMMANDS))
def test_no_card_and_no_device_exits(cmd, video_dir, tmp_path, monkeypatch):
    """Without a card and without --device every model command exits with
    the card error before it reads a file; it never runs on the CPU
    unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device.*--device cpu"):
        cli.main(MODEL_COMMANDS[cmd](video_dir, tmp_path / "missing"))


def test_download_weights_without_huggingface_hub(monkeypatch):
    """With ``huggingface_hub`` not importable both packages raise
    ``ImportError`` naming the manual route, the port's its own loader."""
    from svtpu.data.frames import download_sd_weights as jax_download

    from svtpu_torch.data.frames import download_sd_weights

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="svtpu.perceptual.convert"):
        jax_download("out")
    with pytest.raises(ImportError, match="svtpu_torch.perceptual.convert"
                       r"\.load_torch_checkpoint"):
        download_sd_weights("out")
    with pytest.raises(ImportError, match="huggingface_hub is not"):
        cli.main(["download-weights", "out"])


def test_download_weights_asks_the_hub_as_svtpu(monkeypatch, tmp_path,
                                                 capsys):
    """Against a fake ``huggingface_hub`` (nothing is fetched), both
    packages ask for the same ``repo_id``, ``filename`` and ``local_dir``,
    and ``download-weights`` prints the returned path, as ``svtpu``'s."""
    from svtpu.data.frames import download_sd_weights as jax_download

    from svtpu_torch.data.frames import download_sd_weights

    calls = []
    hub = types.ModuleType("huggingface_hub")
    hub.hf_hub_download = lambda **kw: calls.append(kw) or str(
        Path(kw["local_dir"]) / kw["filename"])
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    assert download_sd_weights(tmp_path) == jax_download(tmp_path)
    assert calls[0] == calls[1] == {
        "repo_id": "CompVis/stable-diffusion-v-1-4-original",
        "filename": "sd-v1-4.ckpt", "local_dir": str(tmp_path)}
    jcli.main(["download-weights", str(tmp_path)])
    want = capsys.readouterr().out
    cli.main(["download-weights", str(tmp_path)])
    assert capsys.readouterr().out == want == f"{tmp_path / 'sd-v1-4.ckpt'}\n"
    assert calls[2] == calls[3] == calls[0]


def test_import_pulls_in_no_plotting_fitting_or_image_library():
    code = ("import sys, svtpu_torch.cli; "
            "print(sorted(m for m in ('matplotlib', 'sklearn', 'PIL') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
