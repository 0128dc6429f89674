"""A command's start-up: ``torch.distributed.tensor`` (and sympy behind it)
is imported only where a "model" mesh axis needs it, and the collectives
still find a ``DTensor`` once it is. Imports no JAX."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from svtpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parent.parent


def _fresh(code: str) -> str:
    """``code`` in a fresh interpreter on the repo: its standard output."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT),
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_import_leaves_dtensor_out():
    """``import svtpu_torch.cli, svtpu_torch.training.trainer,
    svtpu_torch.parallel.distributed`` in a fresh interpreter loads no
    module of ``torch.distributed.tensor``."""
    out = _fresh(
        "import sys\n"
        "import svtpu_torch.cli, svtpu_torch.training.trainer, "
        "svtpu_torch.parallel.distributed\n"
        "print([m for m in sys.modules "
        "if m.startswith('torch.distributed.tensor')])\n")
    assert out.strip() == "[]"


def test_model_axis_trainer_loads_dtensor():
    """In a fresh interpreter on a one-rank gloo group: a ``Trainer`` on a
    data mesh and one on a ``("data", "model")`` mesh leave
    ``torch.distributed.tensor`` unloaded when they are built; the
    model-axis trainer's state shards both fc layers as ``DTensor``s, which
    loads it, and Adam steps them in a group of their own. (Building any
    ``torch.optim.Adam`` loads it too, through ``torch._dynamo``, so the
    state is the first point where it may appear.)"""
    out = _fresh(f"""
import sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, "tests")
from _torch_port import ArrayStore
from svtpu_torch.config import TrainConfig, VideoMeta, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.parallel.mesh import make_mesh
from svtpu_torch.training.trainer import Trainer

def loaded():
    return "torch.distributed.tensor" in sys.modules

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{_port()}",
                        world_size=1, rank=0)
meta = VideoMeta("p", flags=(16, 32), last_frame=47, grey_out=0)
splits = split_segments(meta.state_segments(), 0.15, 0.15)
store = ArrayStore(np.random.default_rng(0).integers(
    0, 255, (48, 32, 32, 3), dtype=np.uint8))
cfg = rbvae_variant("contrastive", latent_dim=8, input_hw=(32, 32))
tcfg = TrainConfig(batch_size=4, contrast_on="p")
Trainer(cfg, tcfg, store, splits, meta.flags,
        mesh=make_mesh((1,), ("data",)), device="cpu")
print("data", loaded())
tr = Trainer(cfg, tcfg, store, splits, meta.flags,
             mesh=make_mesh((1, 1), ("data", "model")), device="cpu")
print("built", loaded())
st = tr.init_state()
print("state", loaded(), type(st.model.encoder_cnn.fc.weight).__name__,
      type(st.model.decoder_cnn.fc.weight).__name__,
      len(st.optimizer.param_groups))
dist.destroy_process_group()
""")
    assert out.split("\n")[:3] == ["data False", "built False",
                                   "state True DTensor DTensor 2"], out


def test_all_reduce_mean_takes_dtensors_and_tensors():
    """``all_reduce_mean_`` on one gloo rank, once ``DTensor``s exist: a
    ``DTensor``'s local block ends as the plain tensor with the same values
    does, in one call that holds both (divided by ``n``, 4 here, which
    the one rank's sum makes visible)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_port()}",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(0)
        base = [torch.randn(6, 4, generator=gen), torch.randn(5, generator=gen)]
        plain = [t.clone() for t in base]
        mesh = init_device_mesh("cpu", (1,))
        dts = [distribute_tensor(t.clone(), mesh, [Shard(0)]) for t in base]
        assert all(distributed.is_dtensor(d) for d in dts)
        assert not any(distributed.is_dtensor(t) for t in plain)
        distributed.all_reduce_mean_([plain[0], dts[0], plain[1], dts[1]],
                                     dist.group.WORLD, 4)
        for b, p, d in zip(base, plain, dts):
            assert torch.equal(p, b / 4)
            assert torch.equal(d.to_local(), p)
    finally:
        dist.destroy_process_group()
