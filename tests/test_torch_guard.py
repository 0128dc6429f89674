"""Guards on the port's boundaries: it imports nothing of JAX or of the JAX
package, and it never runs on the CPU unasked."""
import ast
from pathlib import Path

import pytest
import torch

from svtpu_torch.config import PerceptualConfig, TrainConfig, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.models.autoencoder_kl import AutoencoderKL
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.attention import flash_attention
from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused, check_seed,
                                           seed_args)
from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
from svtpu_torch.ops.lstm import LSTM
from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
from svtpu_torch.perceptual.embed import PerceptualEncoder
from svtpu_torch.pipeline import VideoSymbolPipeline
from svtpu_torch.training.trainer import Trainer

from _torch_port import ArrayStore

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "svtpu")


def _port_files():
    return sorted((ROOT / "svtpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_svtpu():
    files = _port_files()
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"svtpu_torch/cli.py",
            "svtpu_torch/ops/attention.py",
            "svtpu_torch/models/autoencoder_kl.py",
            "svtpu_torch/perceptual/convert.py",
            "svtpu_torch/perceptual/embed.py",
            "svtpu_torch/perceptual/interpolate.py",
            "svtpu_torch/training/trainer.py",
            "svtpu_torch/training/checkpoints.py",
            "svtpu_torch/ops/losses.py",
            "svtpu_torch/data/datasets.py",
            "svtpu_torch/data/frames.py",
            "svtpu_torch/data/multi.py",
            "svtpu_torch/data/native.py",
            "svtpu_torch/ops/conv.py",
            "svtpu_torch/pipeline.py",
            "svtpu_torch/sweeps/runner.py",
            "svtpu_torch/sweeps/spaces.py",
            "svtpu_torch/parallel/mesh.py",
            "svtpu_torch/parallel/sharding.py",
            "svtpu_torch/parallel/distributed.py",
            "svtpu_torch/training/ema.py",
            "svtpu_torch/utils/profiling.py",
            "svtpu_torch/utils/env_check.py",
            "svtpu_torch/models/visualize.py"} <= names
    assert len(files) > 15 and all(f.exists() for f in files)
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imported_roots(f) if mod in FORBIDDEN]
    assert bad == []


def test_no_card_and_no_device_raises(monkeypatch):
    """Entry points default to the card; without one they raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rbvae_variant("contrastive", 8, input_hw=(32, 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqBinaryVAE(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoSymbolPipeline(cfg, {})
    Seq2SeqBinaryVAE(cfg, device="cpu")          # asked for: fine


def test_trainer_with_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rbvae_variant("contrastive", 8, input_hw=(32, 32))
    store = ArrayStore(torch.zeros(20, 32, 32, 3, dtype=torch.uint8).numpy())
    splits = split_segments(((0, 10), (10, 20)), 0.2, 0.2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig(batch_size=4), store, splits, (10,))
    Trainer(cfg, TrainConfig(batch_size=4), store, splits, (10,),
            device="cpu")                        # asked for: fine


def test_perceptual_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PerceptualConfig(ch=32, ch_mult=(1,), num_res_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKL(cfg)
    sd = AutoencoderKL(cfg, device="cpu").state_dict()   # asked for: fine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PerceptualEncoder(sd, cfg)
    enc = PerceptualEncoder(sd, cfg, device="cpu")
    assert enc.model.quant_conv.weight.device.type == "cpu"


def test_wrappers_refuse_devices_without_their_kernel():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises instead of being quietly computed elsewhere."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        binary_concrete_fused(torch.empty(4, 25, **meta), 1)
    with pytest.raises(ValueError):
        flash_attention(*(torch.empty(1, 64, 64, **meta) for _ in range(3)))
    with pytest.raises(ValueError):
        fused_conv01(torch.empty(1, 256, 256, 3, **meta),
                     torch.empty(64, 3, 3, 3, **meta),
                     torch.empty(64, **meta),
                     torch.empty(64, 64, 3, 3, **meta),
                     torch.empty(64, **meta))


def test_fused_lstm_sampler_refuses_devices_without_its_kernel():
    lstm = LSTM(25, 25, 2).to("meta")
    with pytest.raises(ValueError):
        lstm_binary_concrete(lstm, torch.empty(4, 1, 25, device="meta"), 1)


def test_a_seed_tensor_is_never_read_on_the_host():
    """A seed drawn on the card stays there: the check passes the tensor
    through without reading it (a meta tensor has no value to read), and a
    seed on another device than the logits raises instead of being
    copied."""
    seed = torch.empty(1, dtype=torch.int64, device="meta")
    assert check_seed(seed) is seed
    with pytest.raises(ValueError):
        seed_args(seed, torch.device("cpu"))
    assert seed_args(torch.tensor([5]), torch.device("cpu"))[1] == 0
    assert seed_args(5, torch.device("cpu")) == (None, 5)
    for bad in (torch.tensor([1, 2]), torch.tensor([1.0]),
                torch.tensor([1], dtype=torch.int32)):
        with pytest.raises(ValueError):
            check_seed(bad)
    with pytest.raises(ValueError):
        check_seed(-1)
