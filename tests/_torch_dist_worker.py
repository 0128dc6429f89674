"""One rank of the port's multi-process checks
(``tests/test_torch_parallel.py``), over gloo on the CPU. Run as:

    python tests/_torch_dist_worker.py tcp://127.0.0.1:PORT WORLD RANK DIR

With 2 ranks: a data-parallel step and a (1, 2) data x model step against
one process on the same global batch, both fc layers of a (1, 2) model
in its compute dtype, a (1, 2) run's checkpoint (whole
tensors, into ``DIR``) loaded by a one-device model and resumed on the
mesh, ``local_batch_to_global`` and a data-parallel
``PerceptualEncoder``. With 4 ranks: a fused epoch on a
(2, 2) mesh against one process, the batch round-up with its LR scaling,
and ``local_batch_to_global``. Prints ``WORKER_OK <rank>`` at the end.
Imports no JAX.

Losses are compared with float32 compute. Parameters after Adam are
compared with float64 compute (float32 parameters and Adam): with float32
compute the batch split reorders the gradient sums, which moves a gradient
by up to ~1e-5 of its tensor's largest entry, and Adam's first step,
``g / (|g| + eps)``, turns that into up to ~2e-4 of a parameter wherever
``|g|`` is near ``eps``.
"""
import dataclasses
import sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from svtpu_torch.config import (PerceptualConfig, TrainConfig, VideoMeta,
                                rbvae_variant)
from svtpu_torch.data.segments import split_segments
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.parallel.distributed import (initialize,
                                              local_batch_to_global)
from svtpu_torch.parallel.mesh import Mesh, make_mesh
from svtpu_torch.parallel.sharding import parallelize_rbvae
from svtpu_torch.training.trainer import Trainer

META = VideoMeta("p", flags=(16, 32), last_frame=47, grey_out=0)
SPLITS = split_segments(META.state_segments(), 0.15, 0.15)
MCFG = rbvae_variant("contrastive", latent_dim=8, input_hw=(32, 32))
TCFG = TrainConfig(batch_size=4, learning_rate=1e-3, contrast_on="p",
                   contextfree_contrast=True, l1_logits=0.1, margin=2.0,
                   num_steps_to_update=2)


class Store:
    """48 seeded 32x32 frames; row i is frame i (stageable)."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.array = rng.integers(0, 255, (48, 32, 32, 3), dtype=np.uint8)

    @property
    def item_shape(self):
        return self.array.shape[1:]

    def rows(self, idx):
        return np.asarray(idx)

    def gather(self, idx):
        return self.array[np.asarray(idx)]


def single(rank):
    """A one-rank mesh without groups: the single-process path."""
    return Mesh(np.asarray([rank]), ("data",))


def trainer(mesh, cfg=TCFG, dtype="float32"):
    return Trainer(dataclasses.replace(MCFG, compute_dtype=dtype), cfg,
                   Store(), SPLITS, META.flags, mesh=mesh, device="cpu")


def step(tr):
    """One Adam step on epoch 0's first batch; (data-mean loss, params)."""
    state = tr.init_state()
    batch = torch.from_numpy(next(iter(tr.train_batcher.epoch_indices(0)))
                             [tr._lo:tr._hi].astype(np.int64))
    metrics, _ = tr._train_step(state, batch)
    loss = float(tr._data_mean(metrics["total_loss"].reshape(1))[0])
    return loss, tr._full_tree(state)["model"]


def close(a, b, tol, what):
    err = max(float((a[k] - b[k]).abs().max()) for k in a)
    assert set(a) == set(b) and err <= tol, (what, err)


def check_dp_step(rank, world):
    mesh = make_mesh((world,), ("data",))
    loss, _ = step(trainer(mesh))
    ref_loss, _ = step(trainer(single(rank)))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    _, params = step(trainer(mesh, dtype="float64"))
    _, ref = step(trainer(single(rank), dtype="float64"))
    close(params, ref, 1e-5, "data-parallel step")


def check_tp_step(rank, world):
    tr = trainer(make_mesh((1, world), ("data", "model")))
    state = tr.init_state()
    full = trainer(single(rank)).init_state().model.state_dict()
    enc, dec = state.model.encoder_cnn.fc, state.model.decoder_cnn.fc
    assert enc.weight.placements == (Shard(1),), enc.weight.placements
    assert dec.weight.placements == dec.bias.placements == (Shard(0),)
    k = full["encoder_cnn.fc.weight"].shape[1] // world
    assert torch.equal(enc.weight.to_local(), full["encoder_cnn.fc.weight"]
                       [:, rank * k:(rank + 1) * k]), "not its input columns"
    assert not isinstance(state.model.encoder_rnn.lstm.weight_hh_l0, DTensor)
    assert torch.equal(state.model.encoder_rnn.lstm.weight_hh_l0,
                       full["encoder_rnn.lstm.weight_hh_l0"])
    loss, _ = step(tr)
    ref_loss, _ = step(trainer(single(rank)))
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (loss, ref_loss)
    _, params = step(trainer(make_mesh((1, world), ("data", "model")),
                             dtype="float64"))
    _, ref = step(trainer(single(rank), dtype="float64"))
    close(params, ref, 1e-5, "(1, n) step")


def check_tp_compute_dtype(world):
    """Under a (1, n) mesh both fc layers compute in the model's compute
    dtype: the dtype goes by keyword, which the tensor-parallel style's
    input hook passes on (a positional one was dropped, and the fc ran in
    float32)."""
    model = Seq2SeqBinaryVAE(dataclasses.replace(MCFG,
                                                 compute_dtype="float64"),
                             device="cpu")
    parallelize_rbvae(model, make_mesh((1, world), ("data", "model")))
    seen = []
    for fc in (model.encoder_cnn.fc, model.decoder_cnn.fc):
        assert isinstance(fc.weight, DTensor)
        fc.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    x = torch.rand(2, 32, 32, 3, dtype=torch.float64)
    logits = model.encoder_cnn(x)
    model.decoder_cnn(logits)
    assert seen == [torch.float64, torch.float64], seen


def check_tp_checkpoint(world, tmp):
    """A (1, n) run saves whole tensors, which a one-device model loads;
    the run resumes from them on the mesh."""
    save = f"{tmp}/tp"
    mesh = make_mesh((1, world), ("data", "model"))
    hist = trainer(mesh).train(num_epochs=1, save_path=save)
    want = trainer(mesh)._full_tree(hist["final_state"])["model"]
    torch.distributed.barrier()
    tree = torch.load(f"{save}/latest.pt", weights_only=True)
    one = Seq2SeqBinaryVAE(MCFG, device="cpu")
    one.load_state_dict(tree["model"])
    close(tree["model"], want, 0.0, "checkpoint")
    m = tree["optimizer"]["state"][0]["exp_avg"]
    assert m.shape == tree["model"]["encoder_cnn.conv.0.weight"].shape
    again = trainer(mesh).train(num_epochs=2, save_path=save, resume=True)
    assert len(again["train_losses"]) == 1
    assert again["final_state"].step == 2 * hist["final_state"].step


def check_batch_to_global(rank, world):
    mesh = make_mesh((world,), ("data",))
    g = local_batch_to_global(np.full((2, 4), float(rank + 1), np.float32),
                              mesh)
    assert g.shape == (2 * world, 4), g.shape
    total = float(g.sum())
    assert total == sum(8.0 * (r + 1) for r in range(world)), total


def check_embed(rank, world):
    from svtpu_torch.models.autoencoder_kl import AutoencoderKL
    from svtpu_torch.perceptual.embed import PerceptualEncoder

    cfg = PerceptualConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    sd = AutoencoderKL(cfg, device="cpu").state_dict()
    frames = np.random.default_rng(3).integers(0, 255, (5, 32, 32, 3),
                                               dtype=np.uint8)
    mesh = make_mesh((world,), ("data",))
    enc = PerceptualEncoder(sd, cfg, batch_size=3, seed=4, device="cpu",
                            mesh=mesh)
    ref = PerceptualEncoder(sd, cfg, batch_size=4, seed=4, device="cpu",
                            mesh=single(rank))
    assert enc.batch_size == 4
    z, zr = enc.encode_frames(frames), ref.encode_frames(frames)
    assert z.shape == zr.shape == (5, 16, 16, 4)
    np.testing.assert_allclose(z, zr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(enc.decode_latents(zr), ref.decode_latents(zr),
                               rtol=0, atol=1e-6)


def check_fused_epoch_2x2(rank):
    runs = {}
    for name, mesh in (("mesh", make_mesh((2, 2), ("data", "model"))),
                       ("single", single(rank))):
        tr = trainer(mesh, dtype="float64")
        assert tr._bank is not None
        state = tr.init_state()
        losses, _ = tr._fused_epoch(state, 0)
        assert state.step == tr.train_batcher.num_batches() > 1
        runs[name] = losses, tr._full_tree(state)["model"]
    (lm, pm), (ls, ps) = runs["mesh"], runs["single"]
    assert all(np.isfinite(v) for v in lm.values())
    assert abs(lm["total_loss"] - ls["total_loss"]) <= 1e-4 * abs(
        ls["total_loss"])
    close(pm, ps, 1e-5, "(2, 2) fused epoch")


def check_roundup(world):
    mesh = make_mesh((world,), ("data",))
    tr = trainer(mesh, dataclasses.replace(TCFG, batch_size=6))
    assert tr.cfg.batch_size == 8
    np.testing.assert_allclose(tr.cfg.learning_rate, 1e-3 * 8 / 6)
    loss, _ = step(tr)
    assert np.isfinite(loss)
    tr = trainer(mesh, dataclasses.replace(TCFG, batch_size=6,
                                           lr_scaling="none"))
    assert tr.cfg.batch_size == 8 and tr.cfg.learning_rate == 1e-3
    tr = trainer(mesh, dataclasses.replace(TCFG, batch_size=16))
    assert tr.cfg.learning_rate == 1e-3


def main(addr: str, world: int, rank: int, tmp: str) -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    assert initialize(init_method=addr, world_size=world, rank=rank,
                      backend="gloo")
    if world == 2:
        check_dp_step(rank, world)
        check_tp_step(rank, world)
        check_tp_compute_dtype(world)
        check_tp_checkpoint(world, tmp)
        check_batch_to_global(rank, world)
        check_embed(rank, world)
    else:
        check_fused_epoch_2x2(rank)
        check_roundup(world)
        check_batch_to_global(rank, world)
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
