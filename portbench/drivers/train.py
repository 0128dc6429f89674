"""Train cells: ``Trainer.train`` of the configuration's recipe, as the
``train`` command runs it (fused epochs, the val step and the probes every
epoch, the step as a CUDA graph on a card), on seeded frames of the
configuration's video geometry.

Set-up builds one trainer and hands it the benchmark's seeded weights at
its first ``init_state``; ``traffic["warm_epochs"]`` epochs (the eager
warm-up steps, the step's capture, the probes' captures) run before the
window opens at an epoch boundary. The window closes at the first epoch
boundary after ``--seconds``; the harness ends the call there through the
trainer's metrics writer, which the trainer calls at every boundary.

The output check follows the first steps in the plain reference from the
same weights, frames, batches and draws: the mean loss of the first two
epochs, the first gradient as Adam holds it after one step, and the
parameters' change over the first two epochs.
"""
from __future__ import annotations


import numpy as np
import torch

from portbench.reference import data as refdata
from portbench.reference import rbvae as ref

BETA1 = 0.9


class WindowClosed(Exception):
    """Raised from the metrics writer at the boundary that ends the
    window."""


class MemoryStore:
    """Frames in memory with the interface of the program's frame stores
    (``array``, ``indices``, ``rows``, ``gather``, ``item_shape``,
    ``dtype``)."""

    def __init__(self, array: np.ndarray, indices):
        self.array = array
        self.indices = np.asarray(indices)
        self._row = {int(f): r for r, f in enumerate(self.indices)}

    @property
    def item_shape(self):
        return self.array.shape[1:]

    @property
    def dtype(self):
        return self.array.dtype

    def rows(self, frame_indices):
        flat = np.asarray(frame_indices).reshape(-1)
        return np.asarray([self._row[int(i)] for i in flat],
                          np.int64).reshape(np.shape(frame_indices))

    def gather(self, frame_indices):
        return self.array[self.rows(frame_indices)]


def make_frames(video: dict, hw, seed: int, device):
    """The segment frames of the video as seeded uint8 RGB, drawn on
    ``device``: a base colour a state, a smooth pattern of the frame's own
    (a coarse random image upsampled) and fine noise, so that frames of a
    state share their colour and differ as video frames do. Returns the
    frame ids and the ``[frames, H, W, 3]`` array on the host."""
    sp = refdata.splits(video)
    ids = sorted(i for part in sp.values() for s in part for i in s)
    states = torch.tensor([refdata.state_of(i, video["flags"]) for i in ids],
                          device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n = len(ids)
    base = torch.rand((len(video["flags"]) + 1, 3, 1, 1), generator=gen,
                      device=device) * 150.0
    coarse = torch.rand((n, 3, 8, 8), generator=gen, device=device)
    pattern = torch.nn.functional.interpolate(
        coarse, size=tuple(hw), mode="bilinear", align_corners=False)
    x = base[states] + pattern * 80.0 + torch.rand(
        (n, 3) + tuple(hw), generator=gen, device=device) * 20.0
    return ids, (x.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
                 .cpu().numpy())


class Writer:
    """The trainer's metrics writer, standing in for the TensorBoard one:
    called at every epoch boundary with the epoch's mean train metrics."""

    def __init__(self, on_epoch):
        self.on_epoch = on_epoch

    def scalars(self, tag, values, step) -> None:
        if tag == "Epoch/Train":
            self.on_epoch(int(step), values)

    def close(self) -> None:
        pass


def program_configs(config: dict, seed: int):
    from svtpu_torch.config import RBVAEConfig, TrainConfig

    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config["model"].items()}
    t = dict(config["train"])
    t.update(test_pct=config["video"]["test_pct"],
             val_pct=config["video"]["val_pct"], seed=seed, log_dir=None)
    return RBVAEConfig(**model), TrainConfig(**t)


def run(h) -> None:
    from svtpu_torch.config import VideoMeta
    from svtpu_torch.data.segments import split_segments
    from svtpu_torch.training.step_graph import StepGraph
    from svtpu_torch.training.trainer import Trainer

    config, traffic, dev, seed = h.config, h.cell["traffic"], h.device, h.seed
    video, model = config["video"], config["model"]
    mcfg, tcfg = program_configs(config, seed)
    weights = ref.init_weights(model, seed, dev)
    ids, frames = make_frames(video, model["input_hw"], seed + 1, dev)
    meta = VideoMeta(video["name"], tuple(video["flags"]),
                     video["last_frame"], video["grey_out"])
    trainer = Trainer(mcfg, tcfg, MemoryStore(frames, ids),
                      split_segments(meta.state_segments(), tcfg.test_pct,
                                     tcfg.val_pct),
                      meta.flags, device=dev)

    seen = {"states": [], "g1": None, "losses": {}, "recons": {},
            "after": None}
    init_state = trainer.init_state

    def first_grad(opt, args, kwargs):
        if seen["g1"] is not None or (
                dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            return
        names = {id(p): n for n, p in seen["states"][0].model
                 .named_parameters()}
        seen["g1"] = {names[id(p)]: s["exp_avg"].detach().float() / (1 - BETA1)
                      for p, s in opt.state.items()}

    def own_init(seed_offset: int = 0):
        state = init_state(seed_offset)
        if not seen["states"]:
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(weights[n])
            state.optimizer.register_step_post_hook(first_grad)
        seen["states"].append(state)
        return state

    trainer.init_state = own_init
    warm = traffic["warm_epochs"]
    marks = {}

    def on_epoch(epoch, values):
        state = seen["states"][-1]
        if epoch < 2:
            seen["losses"][epoch] = float(values["total_loss"])
            seen["recons"][epoch] = float(values["recon_loss"])
        if epoch == 1:
            seen["after"] = {n: p.detach().float().clone()
                             for n, p in state.model.named_parameters()}
        if epoch == warm - 1:
            marks["captures"] = StepGraph.captures
            marks["step"] = state.step
            h.open_window()
        elif epoch >= warm and h.window_over():
            marks["end_step"] = state.step
            raise WindowClosed

    trainer.writer = Writer(on_epoch)
    try:
        trainer.train(num_epochs=tcfg.num_epochs)
        raise RuntimeError("the run ended before its window closed")
    except WindowClosed:
        pass
    window = h.close_window()
    steps = marks["end_step"] - marks["step"]
    S = len(video["flags"]) + 1
    h.attempted = steps
    h.work["steps"] = steps
    h.e2e["train_frames_per_s"] = steps * 2 * tcfg.batch_size * S / window
    h.note(f"window {window:.3f} s: {steps} steps; step graph captures "
           f"inside it: {StepGraph.captures - marks['captures']}")
    h.read_peak()
    trainer.drop_graphs()
    for st in seen["states"]:
        st.graph = None
    del trainer, seen["states"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if h.world > 1:
        # Every rank holds the same parameters; the first checks them.
        torch.distributed.barrier()
        if h.rank != 0:
            return
    frames_by_id = dict(zip(ids, range(len(ids))))
    check(h, weights, frames, frames_by_id, seen)


def follow(h, weights: dict, frames: np.ndarray, frames_by_id: dict,
           low: bool, steps: int, half: bool = False) -> dict:
    """The reference's first ``steps`` steps: each step's loss and recon
    term, the first gradient, and the parameters after them. ``half``: the
    fault of a step that leaves out half of its batch and takes the mean
    over the rest."""
    config = h.config
    model, t = config["model"], config["train"]
    dt = getattr(torch, model["compute_dtype"])
    params = {k: v.clone() for k, v in weights.items()}
    train = [k for k in params if ref.trainable(k)]
    opt = ref.Adam({k: params[k] for k in train}, t["learning_rate"])
    losses, recons, g1 = [], [], None
    batches = refdata.step_batches(config["video"], t["batch_size"], h.seed,
                                   steps)
    for s, ids in enumerate(batches, start=1):
        rows = np.vectorize(frames_by_id.get)(ids)
        if half:
            rows = rows[:len(rows) // 2]
        batch = torch.from_numpy(frames[rows]).to(h.device)
        leaves = {k: params[k].detach().requires_grad_(k in train)
                  for k in params}
        draws = refdata.StepDraws(h.seed, s, h.device, dt)
        total, terms = ref.pair_loss(leaves, model, t, batch,
                                     refdata.temperature(s, t), draws, low)
        grads = torch.autograd.grad(total, [leaves[k] for k in train])
        grads = dict(zip(train, grads))
        if g1 is None:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(total.detach()))
        recons.append(float(terms["recon"].detach()))
    return {"losses": losses, "recons": recons, "g1": g1, "params": params}


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each leaf's gap of norms: ``| |got| - |want| |`` over the larger of
    ``|want|`` and the median leaf's ``|want|``."""
    norms = {k: float(want[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], med)
            for k in keep}


def epoch_means(run: dict, per: int) -> dict:
    """The first two epochs' mean loss and recon term of a followed run."""
    return {key: {e: float(np.mean(run[key][e * per:(e + 1) * per]))
                  for e in (0, 1)} for key in ("losses", "recons")}


def rel(got: dict, want: dict) -> float:
    return max(abs(got[e] - want[e]) / abs(want[e]) for e in want)


def check(h, weights, frames, frames_by_id, seen) -> None:
    """The numbers compared (each with a limit in the workload file; any
    other is printed and not compared): ``loss_gap`` and ``recon_gap``, the
    worst relative gap of the first two epochs' mean loss and recon term;
    ``grad_gap`` and ``update_gap``, the worst leaf's gap of norms of the
    first gradient and of the change over the first two epochs (as
    ``leaf_gaps``); ``dec_grad_diff``, the worst decoder leaf's norm of the
    first gradient's difference, over the larger of its reference norm and
    the median decoder leaf's (the decoder's gradient comes from the recon
    term alone)."""
    ref.exact_matmuls()
    t = h.config["train"]
    per = len(refdata.epoch_batches(refdata.pair_table(
        refdata.splits(h.config["video"])["train"], h.seed), t["batch_size"],
        h.seed))
    want = follow(h, weights, frames, frames_by_id, False, 2 * per)
    want.update(epoch_means(want, per))
    if h.control or h.fault == "half_batch":
        got = follow(h, weights, frames, frames_by_id, h.control, 2 * per,
                     half=h.fault == "half_batch")
        got.update(epoch_means(got, per))
        got["after"] = got["params"]
    else:
        got = {"losses": seen["losses"], "recons": seen["recons"],
               "g1": seen["g1"], "after": seen["after"]}
    # Leaves whose first gradient is nought to rounding in the reference
    # move under Adam by round-off alone: left out by a rule on it.
    gn = {k: float(g.norm()) for k, g in want["g1"].items()}
    med = float(np.median(list(gn.values())))
    keep = [k for k, v in gn.items() if v >= 1e-3 * med]
    dw = {k: want["params"][k] - weights[k] for k in keep}
    dg = {k: got["after"][k].to(h.device) - weights[k] for k in keep}
    grad = leaf_gaps(got["g1"], want["g1"], keep)
    update = leaf_gaps(dg, dw, keep)
    dec = [k for k in keep if k.startswith("decoder_")]
    dmed = float(np.median([gn[k] for k in dec]))
    diff = {k: float((got["g1"][k].to(h.device) - want["g1"][k]).norm())
            / max(gn[k], dmed) for k in dec}
    for name, gaps in (("grad", grad), ("update", update),
                       ("decoder grad diff", diff)):
        worst = max(gaps, key=gaps.get)
        h.note(f"{name} gaps: worst leaf {worst} {gaps[worst]!r}, median "
               f"leaf {float(np.median(list(gaps.values())))!r}; by leaf "
               + " ".join(f"{k}={v:.3g}" for k, v in gaps.items()))
    numbers = {"loss_gap": rel(got["losses"], want["losses"]),
               "recon_gap": rel(got["recons"], want["recons"]),
               "grad_gap": max(grad.values()),
               "update_gap": max(update.values()),
               "dec_grad_diff": max(diff.values())}
    for name, value in numbers.items():
        if name in h.limits:
            h.compare(name, value, h.limits[name])
        else:
            h.note(f"not compared: {name} {value!r}")
