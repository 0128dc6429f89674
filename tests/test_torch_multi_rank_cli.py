"""The port's command line under a launcher, on the CPU: 2 gloo ranks with
the environment ``python -m torch.distributed.run`` gives each process
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), each running ``tests/_torch_cli_rank.py``. ``train``,
``embed``, ``interpolate``, ``eval-consistency --sd-ckpt`` and ``sweep``
run on both ranks and write one set of files from rank 0, equal to the
one-process run's; ``encode`` runs on rank 0 alone while rank 1 has
returned; a rank that raises fails the launch; each rank writes its kernel
launches where ``SVTPU_LAUNCHES_DIR`` asks. Also the rank helpers in one
process: ``resolve_device`` under a (faked) NCCL group, ``barrier``,
``main_then_barrier``, ``share`` and ``initialize`` for the CPU."""
import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from svtpu import cli as jcli
from svtpu_torch import cli, resolve_device
from svtpu_torch.config import rbvae_variant
from svtpu_torch.data.symbols import SymbolStore
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.parallel import distributed
from svtpu_torch.training.checkpoints import BestCheckpointer

from _torch_cli_rank import (SMALL_AE, SMALL_PERCEP, TINY_SPACE,
                             consistency_argv, embed_argv, encode_argv,
                             interpolate_argv, small_variant, sweep_argv,
                             train_argv)
from _torch_port import seeded_ae_params

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).parent / "_torch_cli_rank.py")
WORLD = 2


def _launch(case: str, data: Path, out: Path, timeout: float = 150):
    """``WORLD`` ranks of the worker, as a launcher starts them: each
    rank's (return code, stdout, stderr)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(WORLD), RANK=str(r), LOCAL_RANK=str(r),
                   SVTPU_LAUNCHES_DIR=str(out / "launches"))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case, str(data), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            results.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """48 tiny JPEGs (3 states), an SD-style checkpoint of the tiny first
    stage (``first_stage_model.*`` names, svtpu's seeded init) and port
    checkpoints of a latent-6 contrastive model and of a latent-6 percep
    model on the tiny first stage's latents."""
    from PIL import Image

    import svtpu.config as jconfig

    import svtpu_torch.config as tconfig
    from svtpu_torch.perceptual.convert import PREFIX, from_jax_params

    d = tmp_path_factory.mktemp("data")
    (d / "frames").mkdir()
    rng = np.random.default_rng(0)
    for i in range(48):
        arr = np.full((32, 32, 3), 40 * (i // 16), np.uint8)
        arr = np.clip(arr + rng.integers(0, 40, arr.size)
                      .reshape(arr.shape), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(d / "frames" / f"{i:010d}.jpg")
    sd = from_jax_params(
        seeded_ae_params(jconfig.PerceptualConfig(**SMALL_AE), 6),
        tconfig.PerceptualConfig(**SMALL_AE))
    torch.save({"state_dict": {PREFIX + k: v for k, v in sd.items()}},
               d / "sd.ckpt")
    cfg = rbvae_variant("contrastive", latent_dim=6, input_hw=(32, 32))
    model = Seq2SeqBinaryVAE(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    BestCheckpointer(d / "ckpt").save({"model": model.state_dict(),
                                       "optimizer": {}}, epoch=0, metric=0.0)
    pcfg = rbvae_variant("percep", latent_dim=6, **SMALL_PERCEP)
    model = Seq2SeqBinaryVAE(pcfg, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    BestCheckpointer(d / "pckpt").save({"model": model.state_dict(),
                                        "optimizer": {}}, epoch=0, metric=0.0)
    return d


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """The worker's commands on 2 ranks: (the output dir, each rank's
    (return code, stdout, stderr))."""
    out = tmp_path_factory.mktemp("ranks")
    results = _launch("commands", data, out)
    for r, (rc, o, e) in enumerate(results):
        assert rc == 0, f"rank {r} failed:\n{o}\n{e}"
        assert f"WORKER_OK {r}" in o, o
    return out, results


def _small_perceptual(monkeypatch):
    """Both packages' ``PerceptualConfig()`` shrunk as the worker shrinks
    the port's."""
    import functools

    import svtpu.config as jconfig

    import svtpu_torch.config as tconfig

    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "PerceptualConfig", functools.partial(
            mod.PerceptualConfig, **SMALL_AE))


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread, as each rank has: the CPU convs' reduction
    order follows the thread count (8 threads move the tiny first stage's
    float32 latents by ~7e-5 of their max against 1 or 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _writes(out: Path, rank: int):
    path = out / f"writes_{rank}.json"
    return json.loads(path.read_text()) if path.exists() else []


def test_train_two_ranks_equal_one_process(two_ranks, data, tmp_path):
    """``train`` on 2 ranks (batch 4, 2 a rank, float64 compute): the
    parameters after 2 epochs within 1e-5 of each tensor's largest |value|
    of the one-process run's; one checkpoint directory, written by rank 0
    alone; rank 1 prints nothing."""
    out, results = two_ranks
    with _one_thread():
        cli.main(train_argv(data, tmp_path / "ref"))
    got, _ = BestCheckpointer(out / "train").restore("latest")
    ref, _ = BestCheckpointer(tmp_path / "ref").restore("latest")
    assert sorted(got["model"]) == sorted(ref["model"])
    for k, v in ref["model"].items():
        err = float((got["model"][k] - v).abs().max())
        assert err <= 1e-5 * float(v.abs().max()), (k, err)
    ckpts = [p for w, p in _writes(out, 0) if w == "checkpoint"
             and Path(p).parent == out / "train"]
    assert sorted(set(ckpts)) == [str(out / "train" / n)
                                  for n in ("best", "latest")]
    assert not [w for w in _writes(out, 1) if w[0] == "checkpoint"]
    assert "best combined" not in results[1][1]
    assert results[1][1].strip() == "WORKER_OK 1"
    assert "best " in results[0][1]


def test_embed_two_ranks_equal_one_process_and_svtpu(two_ranks, data,
                                                      tmp_path, monkeypatch):
    """``embed --deterministic`` on 2 ranks: the latents within 1e-6 of
    their largest |value| of the one-process port's, and within rtol 1e-3,
    atol 1e-4 of ``svtpu.cli``'s on the same checkpoint (the tolerance of
    ``tests/test_torch_cli.py``'s embed parity); one ``.npy``, saved by
    rank 0 alone."""
    out, _ = two_ranks
    _small_perceptual(monkeypatch)
    with _one_thread():
        cli.main(embed_argv(data, tmp_path / "one.npy"))
    jcli.main(embed_argv(data, tmp_path / "ref.npy")[:-2])
    got, one, ref = (np.load(p, allow_pickle=True).item() for p in (
        out / "emb.npy", tmp_path / "one.npy", tmp_path / "ref.npy"))
    assert sorted(got) == sorted(one) == sorted(ref) and len(got) == 48
    top = max(float(np.abs(v).max()) for v in one.values())
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == (1, 4, 16, 32)
        np.testing.assert_allclose(v, one[k], rtol=0, atol=1e-6 * top)
        np.testing.assert_allclose(v, ref[k], rtol=1e-3, atol=1e-4)
    assert [w for w in _writes(out, 0) if w[0] == "np.save"] == [
        ["np.save", str(out / "emb.npy")]]
    assert not [w for w in _writes(out, 1) if w[0] == "np.save"]


def test_interpolate_two_ranks_one_strip(two_ranks, data, tmp_path,
                                         monkeypatch):
    """``interpolate --ckpt random`` on 2 ranks: one strip, written by rank
    0 alone, whose decoded steps are within 1e-5 of their largest |value|
    of the one-process run's."""
    from svtpu_torch.perceptual import interpolate

    out, _ = two_ranks
    _small_perceptual(monkeypatch)
    one = {}
    monkeypatch.setattr(interpolate, "_save_strip",
                        lambda decoded, ts, path: one.setdefault("d", decoded))
    with _one_thread():
        cli.main(interpolate_argv(data, tmp_path / "one.png"))
    got = np.load(out / "strip_0.npy")
    assert got.shape == one["d"].shape == (3, 32, 64, 3)
    np.testing.assert_allclose(got, one["d"], rtol=0,
                               atol=1e-5 * float(np.abs(one["d"]).max()))
    assert [w for w in _writes(out, 0) if w[0] == "strip"] == [
        ["strip", str(out / "interp.png")]]
    assert (out / "interp.png").stat().st_size > 0
    assert not [w for w in _writes(out, 1) if w[0] == "strip"]


def test_eval_consistency_sd_ckpt_two_ranks(two_ranks, data, tmp_path,
                                            monkeypatch):
    """``eval-consistency --variant percep --sd-ckpt`` on 2 ranks, the SD
    re-encode split over them: one results directory, written by rank 0,
    whose CSV equals the one-process run's."""
    import svtpu_torch.config as tconfig

    out, _ = two_ranks
    _small_perceptual(monkeypatch)
    monkeypatch.setattr(tconfig, "rbvae_variant",
                        small_variant(tconfig.rbvae_variant))
    with _one_thread():
        cli.main(consistency_argv(data, tmp_path / "one"))
    got = (out / "consistency" / "consistency.csv").read_text()
    assert got == (tmp_path / "one" / "consistency.csv").read_text()
    assert len(got.strip().splitlines()) == 4    # 3 perturbations + header


def test_rank0_command_runs_once(two_ranks, data, tmp_path):
    """``encode`` runs on rank 0 alone, and rank 1 returns from
    ``cli.main`` before rank 0's encode starts (rank 0 waits for its
    marker); both exit 0, and the codes equal the one-process run's."""
    out, results = two_ranks
    assert (out / "ran_encode_0").exists()
    assert not (out / "ran_encode_1").exists()
    assert (out / "returned_encode_1").exists()
    assert [rc for rc, _, _ in results] == [0] * WORLD
    with _one_thread():
        cli.main(encode_argv(data, tmp_path / "one.npz"))
    got, one = (SymbolStore.load(p) for p in (out / "sym.npz",
                                              tmp_path / "one.npz"))
    assert got.codes.shape == (48, 6)
    np.testing.assert_array_equal(got.codes, one.codes)


def test_sweep_two_ranks_one_set_of_files(two_ranks):
    """A local ``sweep --count 1 --epochs 1`` on 2 ranks: both ranks train
    the same sampled config (the runner also checks it by a hash), and one
    config JSON, one result file and one checkpoint directory are
    written, by rank 0."""
    out, _ = two_ranks
    c0, c1 = (json.loads((out / f"sweep_configs_{r}.json").read_text())
              for r in range(WORLD))
    assert c0[0] == c1[0] and len(c0) == 2 and c0[1] == c1[1]
    sweep = out / "sweep"
    assert sorted(p.name for p in sweep.iterdir()) == [
        "best_model_local_0", "local_0_config.json", "sweep_results.json"]
    assert json.loads((sweep / "local_0_config.json").read_text())[
        "config"] == c0[0]
    assert not [w for w in _writes(out, 1) if w[0] == "checkpoint"]


def test_sweep_two_ranks_equal_one_process(two_ranks, data, tmp_path,
                                           monkeypatch):
    """The local ``sweep`` of the 2 ranks against the same command in one
    process: the same sampled config, key for key, and the same set of
    file names."""
    from svtpu_torch.sweeps import runner

    out, _ = two_ranks
    monkeypatch.setitem(runner.SPACES, "contrastive_p",
                        dict(runner.SPACES["contrastive_p"], **TINY_SPACE))
    trained = []
    train_with_config = runner.train_with_config
    monkeypatch.setattr(runner, "train_with_config",
                        lambda config, *a, **k: trained.append(config)
                        or train_with_config(config, *a, **k))
    with _one_thread():
        cli.main(sweep_argv(data, tmp_path / "sweep", wandb=False))
    two = json.loads((out / "sweep_configs_0.json").read_text())
    assert len(trained) == 1
    assert two[0] == json.loads(json.dumps(trained[0]))
    assert json.loads((out / "sweep" / "local_0_config.json").read_text())[
        "config"] == json.loads((tmp_path / "sweep" / "local_0_config.json")
                                .read_text())["config"]

    def names(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert names(out / "sweep") == names(tmp_path / "sweep")
    assert "best_model_local_0/best.pt" in names(out / "sweep")


def test_each_rank_writes_its_launches(two_ranks):
    """With ``SVTPU_LAUNCHES_DIR`` set, each rank writes
    ``launches_<rank>.json`` when a command returns: the four kernel
    wrappers' launches, all 0 on the CPU (their plain versions run), and
    ``flash_attention``'s by kernel (the D = 72 routes' two keys too)."""
    out, _ = two_ranks
    for r in range(WORLD):
        got = json.loads((out / "launches" / f"launches_{r}.json")
                         .read_text())
        assert got["launches"] == dict.fromkeys(
            ["fused_conv01", "lstm_binary_concrete", "binary_concrete_fused",
             "flash_attention"], 0)
        assert got["flash_attention_by_kernel"] == dict.fromkeys(
            ["bf16_d512", "bf16_d64", "bf16", "f32", "bf16_d72",
             "bf16_d72_window"], 0)


def test_wandb_sweep_reports_from_rank0(two_ranks):
    """A W&B sweep on 2 ranks: rank 0 alone calls ``wandb`` (sweep, agent,
    init, log, save, finish) and hands its run's config to rank 1, which
    trains the same trial."""
    out, _ = two_ranks
    calls = json.loads((out / "wandb_0.json").read_text())
    assert [c[0] for c in calls] == ["sweep", "agent", "init", "log", "save",
                                     "finish"]
    assert calls[1][1:] == ["sid", 1]
    assert np.isfinite(calls[3][1]["best_combined_score"])
    assert not (out / "wandb_1.json").exists()
    assert (out / "sweep_wandb" / "best_model_mock_0" / "best.pt").exists()


def test_a_failing_rank_fails_the_launch(data, tmp_path):
    """Rank 1 raises inside ``train``: it exits non-zero with its
    traceback, and rank 0, waiting on it in a collective, fails too
    instead of hanging or exiting 0."""
    results = _launch("fails", data, tmp_path / "out", timeout=120)
    (rc0, _, e0), (rc1, _, e1) = results
    assert rc1 != 0 and "rank 1 fails on purpose" in e1, e1
    assert rc0 != 0, e0


def test_deterministic_environment_variable(monkeypatch, tmp_path):
    """``SVTPU_DETERMINISTIC=1`` turns PyTorch's deterministic algorithms
    on (warnings only) and sets cuBLAS's workspace before the command
    runs; without it the command leaves them alone."""
    calls = []
    monkeypatch.setattr(torch, "use_deterministic_algorithms",
                        lambda mode, warn_only=False:
                        calls.append((mode, warn_only)))
    monkeypatch.setattr(cli, "cmd_download_weights",
                        lambda args: calls.append(args.cmd))
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.delenv("SVTPU_DETERMINISTIC", raising=False)
    cli.main(["download-weights", str(tmp_path)])
    assert calls == ["download-weights"]
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setenv("SVTPU_DETERMINISTIC", "1")
    cli.main(["download-weights", str(tmp_path)])
    assert calls == ["download-weights", (True, True), "download-weights"]
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_resolve_device_picks_the_ranks_card(monkeypatch):
    """Under an initialised NCCL group a bare "cuda" is the card of
    ``LOCAL_RANK``; an explicit index and the CPU stay as they are; without
    a group "cuda" stays bare (faked: no card here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert resolve_device() == torch.device("cuda", 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    assert resolve_device("cuda") == torch.device("cuda")


def test_rank_helpers_without_a_group(tmp_path):
    """Without a process group ``barrier`` and ``same_on_every_rank`` do
    nothing, ``share`` returns its argument and ``main_then_barrier`` calls
    its function here, the main process."""
    assert not dist.is_initialized() and distributed.is_main()
    distributed.barrier()
    distributed.same_on_every_rank({"a": 1}, "config")
    assert distributed.share([1, 2]) == [1, 2]
    path = tmp_path / "f.txt"
    assert distributed.main_then_barrier(path.write_text, "x") == 1
    assert path.read_text() == "x"


def test_initialize_for_the_cpu_is_gloo():
    """``initialize(device="cpu")`` starts a gloo group (one rank here),
    and then ``barrier``, ``share`` and ``main_then_barrier`` run over
    it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(init_method=f"tcp://127.0.0.1:{port}",
                                  world_size=1, rank=0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert resolve_device("cpu") == torch.device("cpu")
        distributed.barrier()
        distributed.same_on_every_rank({"a": 1}, "config")
        assert distributed.share({"k": 3}) == {"k": 3}
        assert distributed.main_then_barrier(lambda: 7) == 7
    finally:
        dist.destroy_process_group()


def test_plain_materialises_a_collectives_output():
    """A tensor-parallel layer's local output is an
    ``AsyncCollectiveTensor``, whose ``data_ptr`` is 0 (the LSTM kernel read
    there on a (2, 2) mesh): ``_build.plain``, which every launcher calls on
    its inputs, gives a plain tensor holding the same values; a ``DTensor``
    raises; a plain tensor passes through."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, init_device_mesh

    from svtpu_torch.ops import _build

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        x = funcol.all_reduce(torch.arange(6.0).reshape(2, 3), "sum",
                              dist.group.WORLD).view(3, 2)
        assert type(x) is not torch.Tensor and x.data_ptr() == 0
        p = _build.plain(x)
        assert type(p) is torch.Tensor and p.data_ptr() != 0
        assert torch.equal(p, torch.arange(6.0).reshape(3, 2))
        d = DTensor.from_local(torch.ones(2), init_device_mesh("cpu", (1,)),
                               [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            _build.plain(d)
        t = torch.ones(3)
        assert _build.plain(t) is t
    finally:
        dist.destroy_process_group()
