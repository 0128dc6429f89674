"""The train step's one body and its routes, on the CPU: the step with its
temperature in a device tensor, persistent generators seeded anew each step
and device-resident global rows gives the parameters, Adam moments and
metrics of the eager step it replaced (fresh generators a step, a host
float temperature), bit for bit; which route a trainer takes; and the guard
that refuses a CUDA graph off the card. The graph itself runs on the card
only (``chip_smoke.py`` ``phase_train_path``, ``phase_multi_card``)."""
import numpy as np
import pytest
import torch

from svtpu_torch import batch_seed
from svtpu_torch.config import TrainConfig, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.ops import draws
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.parallel.mesh import make_mesh
from svtpu_torch.training.schedules import temperature_schedule
from svtpu_torch.training.step_graph import StepCaptureError
from svtpu_torch.training.trainer import Noise, Trainer

from _torch_port import ArrayStore

B = 4
GEOM = dict(input_hw=(32, 32), conv_features=(8, 8, 8), conv_dropout=0.2)
# The flagship preset's objective at a tiny size; the temperature updates
# at every second step, so three steps cross an anneal update.
TRAIN = dict(batch_size=B, learning_rate=3e-3, init_temperature=2.0,
             final_temperature=0.2, anneal_rate=0.3, num_steps_to_update=2,
             contrast_on="p", contextfree_contrast=True, margin=3.5,
             noise_ratio=0.3, beta_kl=0.2, alpha=4.0, l1_logits=0.1)


def _trainer(remat=False, dtype="float32", **train):
    frames = np.random.default_rng(0).integers(0, 256, (60, 32, 32, 3),
                                               np.uint8)
    splits = split_segments(((0, 20), (20, 40), (40, 60)), 0.2, 0.2)
    mcfg = rbvae_variant("contrastive", 6, remat=remat, compute_dtype=dtype,
                         **GEOM)
    return Trainer(mcfg, TrainConfig(**{**TRAIN, **train}),
                   ArrayStore(frames), splits, (20, 40), device="cpu")


def _old_step(tr, state, batch):
    """The train step before the step graph: fresh generators a step, the
    temperature a host float; no data group here, so no all-reduce."""
    cfg = tr.cfg
    state.step += 1
    temp = max(temperature_schedule(
        state.step, cfg.init_temperature, cfg.final_temperature,
        cfg.anneal_rate, cfg.num_steps_to_update), tr._temp_floor)
    noise = Noise(batch_seed(tr._base_seed, state.step), tr.device,
                  rows=tr._rows)
    state.optimizer.zero_grad(set_to_none=True)
    total, metrics = tr._objective()(state.model, cfg, tr._batch(batch),
                                     temp, False, noise, deterministic=False)
    total.backward()
    state.optimizer.step()
    return torch.stack([metrics[k].detach().float()
                        for k in sorted(metrics)]), temp


def _snapshot(state):
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {(i, k): v.clone() for i, s in opt.items() for k, v in s.items()})


@pytest.mark.parametrize("case", ["dropout", "remat", "bf16", "rows"])
def test_step_body_is_the_eager_step_bit_for_bit(case):
    """Three steps of ``Trainer._step`` against three of the eager step it
    replaced, from the same state and batches, with the temperature floor
    raised above the schedule before the third: every metric, parameter
    and Adam moment equal, and the temperatures too. ``rows``: the batch is
    rank 1's half of a global one, its draws taken at its rows."""
    runs = []
    for step in (_old_step, lambda tr, st, b: tr._step(st, b)):
        tr = _trainer(remat=case == "remat",
                      dtype="bfloat16" if case == "bf16" else "float32")
        idx = torch.from_numpy(np.stack([
            next(iter(tr.train_batcher.epoch_indices(e)))
            for e in range(3)]).astype(np.int64))
        if case == "rows":
            tr._rows = draws.GlobalRows(torch.tensor([2, 3, 6, 7]), 2 * B)
            idx = idx[:, 2:]
        state = tr.init_state()
        out = []
        for i in range(3):
            if i == 2:
                tr._temp_floor = 1.5
            vec, temp = step(tr, state, idx[i])
            out.append((vec.clone(), temp))
        runs.append((out, _snapshot(state)))
    # remat's recompute took a replica of each conv stack's generator.
    n = 2 if case == "remat" else 1
    assert [len(r.generators) for r in tr._gens.dropout(0)] == [n, n]
    (old, (p_old, m_old)), (new, (p_new, m_new)) = runs
    temps = [t for _, t in old]
    assert temps == [t for _, t in new]
    assert temps[0] == 2.0 > temps[1] and temps[2] == 1.5, temps
    for (a, _), (b, _) in zip(old, new):
        assert torch.equal(a, b)
    assert p_old.keys() == p_new.keys() and m_old.keys() == m_new.keys()
    for k in p_old:
        assert torch.equal(p_old[k], p_new[k]), k
    for k in m_old:
        assert torch.equal(m_old[k], m_new[k]), k
    assert any(k[1] == "exp_avg_sq" for k in m_old)


def test_replicas_draw_alike_and_are_made_once():
    """Every replica of a seed draws what a fresh generator seeded so
    draws; seeding again hands out the same generators from the first."""
    reps = draws.Replicas("cpu", 5)
    a, b = reps.take(), reps.take()
    fresh = torch.rand(7, generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.rand(7, generator=a), fresh)
    assert torch.equal(torch.rand(7, generator=b), fresh)
    reps.seed(6)
    assert reps.take() is a and reps.take() is b and len(reps.generators) == 2
    assert torch.equal(torch.rand(7, generator=a), torch.rand(
        7, generator=torch.Generator().manual_seed(6)))


def test_route_follows_the_device_and_the_mesh():
    """A CUDA device with no "model" axis takes the graph; the CPU and a
    "model" axis run eagerly. A CPU trainer runs eagerly with Adam not
    capturable (the CPU refuses it), on any mesh."""
    data, model = make_mesh((1,), ("data",)), make_mesh((1, 1),
                                                        ("data", "model"))
    cuda = torch.device("cuda", 0)
    assert graph_route(cuda, data) == "graph"
    assert graph_route("cuda", make_mesh((1,), ("data",))) == "graph"
    assert graph_route(cuda, model) == "eager"
    assert graph_route("cpu", data) == graph_route("cpu", model) == "eager"
    for mesh in ((1,), (1, 1)):
        axes = ("data", "model")[:len(mesh)]
        tr = _trainer(mesh_shape=mesh, mesh_axes=axes)
        state = tr.init_state()
        assert not tr._graphed and state.graph is None
        assert not state.optimizer.param_groups[0]["capturable"]
        tr._step(state, torch.from_numpy(next(iter(
            tr.train_batcher.epoch_indices(0)))))
        assert state.graph is None


def test_graph_off_the_card_raises():
    """Forced onto the graph route, a CPU trainer's step raises and names
    the device: it never trains eagerly in the graph's place."""
    tr = _trainer()
    tr._graphed = True
    state = tr.init_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(StepCaptureError, match="CUDA device, not cpu"):
        tr._step(state, torch.from_numpy(next(iter(
            tr.train_batcher.epoch_indices(0)))))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_resume_takes_this_trainers_adam(tmp_path):
    """A checkpoint saved with capturable Adam (on the card) resumes on the
    CPU with this trainer's: the next step runs."""
    tr = _trainer()
    state = tr.init_state()
    batch = torch.from_numpy(next(iter(tr.train_batcher.epoch_indices(0))))
    tr._step(state, batch)
    tree = tr._full_tree(state)
    for group in tree["optimizer"]["param_groups"]:
        group["capturable"] = True
    fresh = tr.init_state()
    tr._load_full(fresh, tree)
    assert not fresh.optimizer.param_groups[0]["capturable"]
    tr._step(fresh, batch)
    assert all(torch.isfinite(p).all() for p in fresh.model.parameters())


def test_fused_epoch_equals_per_step_epoch_with_floor_raised():
    """Two staged epochs of two steps and the same epochs one step at a
    time end on the same parameters bit for bit, with the floor raised
    between the epochs."""
    params = []
    for fused in (True, False):
        tr = _trainer(dtype="float32")
        state = tr.init_state()
        for epoch in range(2):
            if fused:
                tr._fused_epoch(state, epoch)
            else:
                tr._per_step_epoch(state, epoch)
            tr._temp_floor = 0.9
        params.append(state.model.state_dict())
    for k, v in params[0].items():
        assert torch.equal(v, params[1][k]), k
