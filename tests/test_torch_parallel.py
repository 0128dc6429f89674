"""The port's meshes, partition rules and data / tensor parallelism on the
CPU: the counterparts of the 9 tests of ``tests/test_parallel.py``. Meshes,
padding, the rules and the global-row draws run in this process; the rest
runs in ``tests/_torch_dist_worker.py``, launched once with 2 gloo ranks
and once with 4."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svtpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from svtpu_torch.config import rbvae_variant
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import draws
from svtpu_torch.parallel import distributed
from svtpu_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh,
                                       pad_to_multiple, replicated)
from svtpu_torch.parallel.sharding import (AUTOENCODER_TP_RULES,
                                           RBVAE_TP_RULES, params_shardings,
                                           shard_params)

ROOT = Path(__file__).resolve().parent.parent


def test_make_mesh_shapes():
    """Without a process group the world is one rank: -1 absorbs it, and a
    shape that needs more ranks raises naming both numbers."""
    m = make_mesh((-1,), ("data",))
    assert m.shape == (1,) and m.device_mesh is None and m.rank("data") == 0
    assert m.group("data") is None
    m2 = make_mesh((-1, 1), ("data", "model"))
    assert m2.shape == (1, 1) and m2.size("model") == 1
    assert m2.size("pipeline") == 1
    with pytest.raises(ValueError, match=r"needs 8 ranks; there are 1"):
        make_mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="at most one -1"):
        make_mesh((-1, -1), ("data", "model"))


def test_pad_to_multiple():
    x = np.arange(10).reshape(5, 2)
    p, n = pad_to_multiple(x, 4)
    assert p.shape == (8, 2) and n == 5
    np.testing.assert_array_equal(p[5:], np.tile(x[:1], (3, 1)))
    for m in (1, 3, 5):
        a, b = pad_to_multiple(x, m), jax_pad_to_multiple(x, m)
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])


def test_sharding_rules_fallback_when_indivisible():
    """A rule whose split dimension the axis does not divide falls back to
    replication; on a divisible one the specs are torch's layouts of
    ``svtpu``'s (flax ``[in, out]`` kernels are ``[out, in]`` here)."""
    mesh = Mesh(np.arange(8).reshape(1, 8), ("data", "model"))
    sh = params_shardings({"encoder_cnn.fc.weight": torch.zeros(5, 12)},
                          mesh, RBVAE_TP_RULES)
    assert sh["encoder_cnn.fc.weight"].spec == ()

    mesh2 = Mesh(np.arange(2).reshape(1, 2), ("data", "model"))
    model = Seq2SeqBinaryVAE(rbvae_variant("contrastive", 8,
                                           input_hw=(32, 32)), device="cpu")
    specs = {k: v.spec for k, v in params_shardings(model, mesh2).items()}
    assert specs["encoder_cnn.fc.weight"] == (None, "model")
    assert specs["decoder_cnn.fc.weight"] == ("model", None)
    assert specs["decoder_cnn.fc.bias"] == ("model",)
    assert {k for k, s in specs.items() if s} == {
        "encoder_cnn.fc.weight", "decoder_cnn.fc.weight",
        "decoder_cnn.fc.bias"}
    local = shard_params(model, mesh2)     # rank 0 of the model axis
    assert torch.equal(local["encoder_cnn.fc.weight"],
                       model.encoder_cnn.fc.weight[:, :512])
    assert torch.equal(local["decoder_cnn.fc.weight"],
                       model.decoder_cnn.fc.weight[:512])

    ae = {"encoder.mid.attn_1.q.weight": torch.zeros(64, 64, 1, 1),
          "encoder.mid.attn_1.proj_out.weight": torch.zeros(64, 64, 1, 1),
          "decoder.up.0.block.0.conv1.weight": torch.zeros(32, 64, 3, 3),
          "encoder.down.0.downsample.conv.weight": torch.zeros(32, 32, 3, 3),
          "encoder.conv_out.weight": torch.zeros(8, 64, 3, 3)}
    specs = {k: v.spec for k, v in params_shardings(
        ae, mesh2, AUTOENCODER_TP_RULES).items()}
    assert specs == {
        "encoder.mid.attn_1.q.weight": ("model", None, None, None),
        "encoder.mid.attn_1.proj_out.weight": (None, "model", None, None),
        "decoder.up.0.block.0.conv1.weight": ("model", None, None, None),
        "encoder.down.0.downsample.conv.weight": (),
        "encoder.conv_out.weight": ("model", None, None, None)}
    assert batch_sharding(mesh2).local(torch.arange(6)).tolist() == \
        list(range(6))
    assert replicated(mesh2).spec == ()


def test_global_rows_draw_the_global_batchs_rows():
    """A rank's draws at its rows equal the global draw's rows, with the
    leading dim a multiple of the rows (``[B, T]`` flattened)."""
    rows = draws.GlobalRows(torch.tensor([2, 3, 6, 7]), 8)
    for shape in ((4, 5), (12, 2, 3)):
        k = shape[0] // 4
        full = torch.rand((8 * k,) + shape[1:],
                          generator=torch.Generator().manual_seed(9))
        got = draws.rand(shape, draws.ShardedGenerator(
            torch.Generator().manual_seed(9), rows))
        want = full.reshape((8, k) + shape[1:])[rows.rows].reshape(shape)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not a multiple"):
        draws.randn((5, 2), draws.ShardedGenerator(torch.Generator(), rows))


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    for k in ("WORLD_SIZE", "MASTER_ADDR", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_on_nccl_without_a_card_raises(monkeypatch):
    """NCCL is the default and needs a card; it does not fall back to
    gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        distributed.initialize(init_method="tcp://127.0.0.1:1",
                               world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


def _launch(world: int, timeout: float, tmp: Path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    worker = str(Path(__file__).parent / "_torch_dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, f"tcp://127.0.0.1:{port}", str(world),
         str(r), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"WORKER_OK {r}" in out, out


def test_two_ranks_data_and_tensor_parallel(tmp_path):
    """2 gloo ranks: a data-parallel step and a (1, 2) data x model step
    against one process, a (1, 2) checkpoint loaded by one device and
    resumed, ``local_batch_to_global``, and a data-parallel
    ``PerceptualEncoder`` (``_torch_dist_worker.py``)."""
    _launch(2, timeout=150, tmp=tmp_path)


def test_four_ranks_fused_epoch_and_roundup(tmp_path):
    """4 gloo ranks: a fused epoch on a (2, 2) mesh against one process,
    and the batch round-up with its LR scaling."""
    _launch(4, timeout=150, tmp=tmp_path)
