"""One rank of the port's command line under a launcher's environment
(``tests/test_torch_multi_rank_cli.py``), over gloo on the CPU. Run as:

    MASTER_ADDR=127.0.0.1 MASTER_PORT=PORT WORLD_SIZE=N RANK=R \\
        LOCAL_RANK=R python tests/_torch_cli_rank.py CASE DATA OUT

as ``python -m torch.distributed.run`` would start it. ``DATA`` holds the
inputs the test wrote (``frames/``, ``sd.ckpt``, ``ckpt/``); each command
writes under ``OUT``. The SD first stage is shrunk as
``tests/test_torch_cli.py`` shrinks it, and the sweep's space as
``tests/test_torch_sweeps.py`` shrinks it.

CASE ``commands`` runs, each through ``svtpu_torch.cli.main`` with
``--device cpu`` (every call starts the process group and tears it down;
each on the next port after ``MASTER_PORT``):
``train`` (2 epochs, float64 compute), ``embed --deterministic``,
``interpolate --ckpt random``, ``eval-consistency --variant percep
--sd-ckpt`` (a small percep model), ``encode`` (rank 0 alone; each rank
that runs it leaves a marker, and rank 0's waits until rank 1 has
returned from ``cli.main``), a local ``sweep`` and a W&B ``sweep``
against a fake ``wandb`` module; each rank records the checkpoints,
``np.save`` files and interpolation strips it writes, the sweep configs
it trains and its ``wandb`` calls. CASE ``fails``: rank 1 raises inside
``train``. Prints ``WORKER_OK <rank>`` at the end. Imports no JAX.
"""
import functools
import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

import svtpu_torch.config as tconfig
from svtpu_torch import cli
from svtpu_torch.perceptual import interpolate
from svtpu_torch.sweeps import runner
from svtpu_torch.training.checkpoints import BestCheckpointer
from svtpu_torch.training.trainer import Trainer

SMALL_AE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resize_wh=(64, 32),
                compute_dtype="float32")
# The percep model on the small first stage's [4, 16, 32] latents.
SMALL_PERCEP = dict(input_hw=(16, 32), conv_features=(8, 8, 8))
TINY_SPACE = {"latent_dim": ("const", 6), "batch_size": ("const", 4),
              "num_epochs": ("const", 1)}
VIDEO = ["--video", "tiny", "--flags", "16", "32", "--last-frame", "47",
         "--grey-out", "0", "--resolution", "32"]
CPU = ["--device", "cpu"]


def train_argv(data: Path, save: Path):
    """``train`` of a small contrastive model, float64 compute: the batch
    split reorders the gradient sums, which float64 keeps below 1e-12."""
    return ["train", *VIDEO, "--frames-dir", str(data / "frames"),
            "--latent-dim", "6", "--batch-size", "4", "--epochs", "2",
            "--contrast-on", "p", "--contextfree-contrast", "--margin", "2.0",
            "--l1-logits", "0.1", "--num-steps-to-update", "2", "--dtype",
            "float64", "--save-path", str(save), *CPU]


def embed_argv(data: Path, out: Path):
    return ["embed", str(data / "frames"), str(out), "--ckpt",
            str(data / "sd.ckpt"), "--batch-size", "4", "--deterministic",
            *CPU]


def encode_argv(data: Path, out: Path):
    return ["encode", str(data / "frames"), "--ckpt", str(data / "ckpt"),
            "--latent-dim", "6", "--resolution", "32", "--deterministic",
            "--dtype", "float32", "--out", str(out), *CPU]


def interpolate_argv(data: Path, out: Path):
    return ["interpolate", str(data / "frames" / "0000000000.jpg"),
            str(data / "frames" / "0000000047.jpg"), "--ckpt", "random",
            "--steps", "3", "--out", str(out), *CPU]


def consistency_argv(data: Path, out: Path):
    return ["eval-consistency", *VIDEO, "--frames-dir", str(data / "frames"),
            "--variant", "percep", "--ckpt", str(data / "pckpt"),
            "--latent-dim", "6", "--sd-ckpt", str(data / "sd.ckpt"),
            "--trials", "1", "--out-dir", str(out), *CPU]


def small_variant(rbvae_variant):
    """``rbvae_variant`` with the percep model shrunk to ``SMALL_PERCEP``."""
    def variant(name, *args, **kwargs):
        if name == "percep":
            kwargs = {**SMALL_PERCEP, **kwargs}
        return rbvae_variant(name, *args, **kwargs)
    return variant


def sweep_argv(data: Path, save: Path, wandb: bool):
    return ["sweep", *VIDEO, "--frames-dir", str(data / "frames"),
            "--variant", "contrastive_p", "--count", "1", "--epochs", "1",
            "--seed", "0", "--save-dir", str(save), *CPU,
            *([] if wandb else ["--no-wandb"])]


def shrink() -> None:
    """The tiny SD first stage and sweep space, on this rank."""
    tconfig.PerceptualConfig = functools.partial(tconfig.PerceptualConfig,
                                                 **SMALL_AE)
    tconfig.rbvae_variant = small_variant(tconfig.rbvae_variant)
    runner.SPACES["contrastive_p"] = dict(runner.SPACES["contrastive_p"],
                                          **TINY_SPACE)


def fake_wandb(rank: int, out: Path):
    """A ``wandb`` module whose agent runs one trial on a config the port's
    sampler draws; each call is recorded in ``wandb_<rank>.json``."""
    calls = []
    path = out / f"wandb_{rank}.json"

    def record(name, *args):
        calls.append([name, *args])
        path.write_text(json.dumps(calls, default=str))

    class Run:
        config = runner.sample(runner.SPACES["contrastive_p"],
                               np.random.default_rng(7))
        name, id = "mock_0", "0"

        def finish(self):
            record("finish")

    def agent(sweep_id, function=None, count=1):
        record("agent", sweep_id, count)
        for _ in range(count):
            function()

    def init():
        record("init")
        return Run()

    mod = types.ModuleType("wandb")
    mod.sweep = lambda cfg, project=None: record("sweep", project) or "sid"
    mod.agent = agent
    mod.init = init
    mod.log = lambda d: record("log", d)
    mod.save = lambda p: record("save", p)
    return mod


def record_writes(rank: int, out: Path) -> None:
    """Each checkpoint, ``np.save`` and interpolation strip this rank
    writes, listed in ``writes_<rank>.json``; a strip's decoded steps also
    go to ``strip_<rank>.npy``."""
    writes = []

    def note(what, path):
        writes.append([what, str(path)])
        (out / f"writes_{rank}.json").write_text(json.dumps(writes))

    ckpt_write = BestCheckpointer._write
    np_save = np.save

    def ckpt(self, host_tree, meta, name):
        note("checkpoint", self.directory / name)
        return ckpt_write(self, host_tree, meta, name)

    def save(path, *args, **kwargs):
        note("np.save", path)
        return np_save(path, *args, **kwargs)

    save_strip = interpolate._save_strip

    def strip(decoded, ts, out_path):
        note("strip", out_path)
        np_save(out / f"strip_{rank}.npy", decoded)
        return save_strip(decoded, ts, out_path)

    BestCheckpointer._write = ckpt
    np.save = save
    interpolate._save_strip = strip


def next_port() -> None:
    """A new ``MASTER_PORT`` for the next command's process group: a group
    started again on the port of one torn down in the same process can
    find the old store still serving it."""
    os.environ["MASTER_PORT"] = str(int(os.environ["MASTER_PORT"]) + 1)


def run_commands(rank: int, data: Path, out: Path) -> None:
    record_writes(rank, out)
    cli.main(train_argv(data, out / "train"))
    next_port()
    cli.main(embed_argv(data, out / "emb.npy"))
    next_port()
    cli.main(interpolate_argv(data, out / "interp.png"))
    next_port()
    cli.main(consistency_argv(data, out / "consistency"))

    encode = cli.cmd_encode
    returned = out / "returned_encode_1"

    def marked_encode(args):
        (out / f"ran_encode_{rank}").write_text("")
        # Rank 1 does not wait for rank 0's command: it has returned
        # before rank 0 encodes.
        deadline = time.monotonic() + 60
        while not returned.exists():
            if time.monotonic() > deadline:
                raise RuntimeError("rank 1 is still in cli.main")
            time.sleep(0.05)
        return encode(args)

    cli.cmd_encode = marked_encode
    next_port()
    cli.main(encode_argv(data, out / "sym.npz"))
    (out / f"returned_encode_{rank}").write_text("")

    trained = []
    train_with_config = runner.train_with_config

    def recorded(config, *args, **kwargs):
        trained.append(config)
        (out / f"sweep_configs_{rank}.json").write_text(json.dumps(trained))
        return train_with_config(config, *args, **kwargs)

    runner.train_with_config = recorded
    next_port()
    cli.main(sweep_argv(data, out / "sweep", wandb=False))
    sys.modules["wandb"] = fake_wandb(rank, out)
    next_port()
    cli.main(sweep_argv(data, out / "sweep_wandb", wandb=True))


def run_failing(rank: int, data: Path, out: Path) -> None:
    if rank == 1:
        def broken(self, *args, **kwargs):
            raise RuntimeError("rank 1 fails on purpose")

        Trainer.train = broken
    cli.main(train_argv(data, out / "train"))


def main(case: str, data: str, out: str) -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    shrink()
    {"commands": run_commands, "fails": run_failing}[case](
        rank, Path(data), Path(out))
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
