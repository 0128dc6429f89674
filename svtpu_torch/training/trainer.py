"""RBVAE trainer for the contrastive, triplet and simple objectives
(``svtpu/training/trainer.py:78-1088``), on one device or over a mesh of
ranks (``parallel/``).

A train step sends both pair members through the model as one ``[2B, S]``
batch, normalises uint8 frames on the device, and updates the parameters
with Adam (optax's defaults). On a CUDA device whose mesh has no "model"
axis the step is one CUDA graph, captured once a train state and replayed
at every step (``step_graph.py``), as ``svtpu`` jits its step; on the CPU
and under a "model" axis it runs eagerly (``graph_route``). One body serves
both routes (``Trainer._step_body``). The differences from the JAX package:

  * The context-free passes use only the encoder's ``h``; under ``jit``
    XLA drops the decoder of those passes, here they run the encoder half
    (``Seq2SeqBinaryVAE._encode_to_latent``) alone, for the same values.
  * A staged epoch (``fused_epoch``, ``svtpu``'s ``lax.scan`` epoch) keeps
    its per-step metric sums on the device and reads them back once; its
    row indices go up once, before the first step, and its steps never
    wait for the device. The step counter lives on the host, so the
    temperature of every step and its floor are host floats; each step
    writes its temperature into a 0-dim device tensor that the step reads
    (a CUDA graph would hold a Python number as a constant).
  * Randomness: step ``s`` seeds its generators from
    ``batch_seed(seed + 1, s)`` (``Noise``), where the JAX step folds its
    key by the step. The generators are made once a trainer and seeded
    anew before every step (``StepGenerators``), so that a graph can hold
    them. The streams differ (Philox or Mersenne Twister against
    threefry); the objectives take injected uniforms so that tests can feed
    both packages the same draws.
  * ``nn.LSTM`` holds two biases a layer where ``svtpu`` has one
    (``svtpu/ops/lstm.py:57-61``). Adam would move each by ~lr a step, the
    sum twice as far as in ``svtpu``, so ``init_state`` folds ``bias_hh``
    into ``bias_ih`` and leaves it out of the optimizer (``fold_lstm_biases``).
  * Parallelism is one process a rank over ``torch.distributed``, where
    ``svtpu`` shards one program. On a "data" axis every rank builds the
    same global index batch and trains on its rows; its noise and dropout
    masks are the global batch's draws at those rows (``ops/draws.py``), so
    the ranks train the model one device trains. Gradients are averaged
    over the axis before Adam, parameters broadcast from rank 0 at
    ``init_state``, metrics averaged; validation and the probes run whole
    on every rank, and rank 0 writes the checkpoints. A "model" axis shards
    ``encoder_cnn.fc`` row-wise and ``decoder_cnn.fc`` column-wise with
    torch's tensor-parallel styles (``parallel/sharding.py``); checkpoints
    hold the whole tensors.

The kernels are inference-only in both packages: the train step takes the
plain trunk and sampler, and the probes (``encode_frames``) route through
the hand-written kernels when the model config sets ``pallas_trunk`` /
``pallas_sampler``, as ``svtpu``'s probes route through its Pallas kernels.
On the step's graph route the probes run as CUDA graphs too, one a train
state and key (``models/encode_graph.py``, ``svtpu``'s jitted ``enc`` and
``enc_rows``): the temperature reaches them through a device tensor, so one
graph serves every epoch; ``train`` frees them when it returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import signal
import time
from typing import Optional, Sequence

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig, TrainConfig
from svtpu_torch.data.datasets import PairBatcher, SegmentBatcher
from svtpu_torch.data.prefetch import prefetch_to_device
from svtpu_torch.data.segments import SplitIndices, assign_label
from svtpu_torch.evaluation.common import encode_chunks
from svtpu_torch.evaluation.hamming import adjacent_hamming, modal_codes
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops import losses
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.ops.draws import GlobalRows, Replicas
from svtpu_torch.ops.image import to_float01
from svtpu_torch.parallel import distributed
from svtpu_torch.parallel.mesh import make_mesh
from svtpu_torch.parallel.sharding import (full_optimizer_state,
                                           full_state_dict, local_state,
                                           parallelize_rbvae)
from svtpu_torch.training.checkpoints import BestCheckpointer
from svtpu_torch.training.metrics import MetricsWriter
from svtpu_torch.training.schedules import temperature_schedule
from svtpu_torch.training.step_graph import StepGraph
from svtpu_torch.utils.profiling import span

_M32 = 0xFFFFFFFF


def fold(key: int, i: int) -> int:
    """``batch_seed`` of a 64-bit key, both of whose halves reach the
    result (``batch_seed`` keeps the low 32 bits of its seed)."""
    return batch_seed((key ^ (key >> 32)) & _M32, i)


class StepGenerators:
    """The generators of a trainer's steps, made once and seeded anew before
    every step (``seed``) with what ``Noise`` seeds fresh ones with: pass
    ``k``'s Binary-Concrete noise ``fold(key, 2k)``, its dropout masks
    ``batch_seed(fold(key, 2k + 1), stage)`` (stage 0 the encoder's conv
    stack, 1 the decoder's). Each is a ``draws.Replicas``, made at its first
    use, so the eager step and a CUDA graph of it, which can hold only
    generators that outlive it (``all``), draw the same."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.key: Optional[int] = None
        self._noise: dict = {}       # pass -> Replicas
        self._dropout: dict = {}     # pass -> (Replicas, Replicas)

    def seed(self, key: int) -> None:
        self.key = key
        for k, r in self._noise.items():
            r.seed(fold(key, 2 * k))
        for k, stages in self._dropout.items():
            for stage, r in enumerate(stages):
                r.seed(batch_seed(fold(key, 2 * k + 1), stage))

    def noise(self, k: int) -> torch.Generator:
        if k not in self._noise:
            self._noise[k] = Replicas(self.device, fold(self.key, 2 * k))
        return self._noise[k].take()

    def dropout(self, k: int) -> tuple:
        if k not in self._dropout:
            seed = fold(self.key, 2 * k + 1)
            self._dropout[k] = tuple(Replicas(self.device,
                                              batch_seed(seed, stage))
                                     for stage in (0, 1))
        return self._dropout[k]

    def all(self) -> list:
        reps = [*self._noise.values(),
                *(r for stages in self._dropout.values() for r in stages)]
        return [g for r in reps for g in r.generators]


class Noise:
    """The randomness of one objective evaluation.

    Pass 0 is the pair (or segment) pass, pass 1 the context-free pass of
    the contrastive margins, pass 2 the context-free pass of the triplet
    push. Pass ``k`` draws its Binary-Concrete noise from a generator on
    ``device`` seeded with ``fold(key, 2k)``, or takes ``uniforms[k]``
    where uniforms are given (tests feed JAX's draws so), and its dropout
    masks from ``fold(key, 2k + 1)``. ``generators``: the trainer's
    persistent ones, seeded with ``key`` (``StepGenerators.seed``), in
    place of fresh generators. ``rows``: the batch is a data-parallel
    rank's rows of a global one, and both draws are taken at them
    (``ops/draws.py``).
    """

    def __init__(self, key: Optional[int], device, uniforms=None,
                 rows: Optional[GlobalRows] = None,
                 generators: Optional[StepGenerators] = None):
        self.key = key
        self.device = torch.device(device)
        self.uniforms = uniforms
        self.rows = rows
        self.generators = generators

    def generator(self, k: int) -> Optional[torch.Generator]:
        if self.uniforms is not None or self.key is None:
            return None
        if self.generators is not None:
            return self.generators.noise(k)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold(self.key, 2 * k))
        return gen

    def u(self, k: int) -> Optional[torch.Tensor]:
        return None if self.uniforms is None else self.uniforms[k]

    def dropout_seed(self, k: int):
        """Pass ``k``'s dropout masks for the model (``DropoutSeed``): a host
        int, or the persistent generators of its two conv stacks."""
        if self.key is None:
            return None
        if self.generators is not None:
            return self.generators.dropout(k)
        return fold(self.key, 2 * k + 1)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the number of optimizer steps taken (a host
    int), and on the graph route the CUDA graph of its step."""

    step: int
    model: Seq2SeqBinaryVAE
    optimizer: torch.optim.Optimizer
    graph: Optional[StepGraph] = None


def fold_lstm_biases(model: torch.nn.Module) -> None:
    """Give every LSTM layer of ``model`` one trainable bias, as ``svtpu``'s
    has: ``bias_ih += bias_hh``, ``bias_hh = 0`` and frozen."""
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, torch.nn.LSTM):
                continue
            for k in range(m.num_layers):
                b_ih = getattr(m, f"bias_ih_l{k}")
                b_hh = getattr(m, f"bias_hh_l{k}")
                b_ih += b_hh
                b_hh.zero_()
                b_hh.requires_grad_(False)


def _staging_nbytes(store) -> int:
    """Bytes of the device bank a store would stage; 0 when it cannot. For
    a ``MultiStore`` the sub-stores' arrays are summed without touching
    its ``array``, which would concatenate them on the host even where
    staging is then declined."""
    subs = getattr(store, "stores", None)
    if subs is not None:
        if not all(hasattr(s, "array") and hasattr(s, "rows")
                   for s in subs):
            return 0
        return sum(int(s.array.nbytes) for s in subs)
    if hasattr(store, "array") and hasattr(store, "rows"):
        return int(getattr(store.array, "nbytes", 0))
    return 0


def _prep(batch: torch.Tensor) -> torch.Tensor:
    """uint8 frames → float [0,1]; float embeddings pass through."""
    if batch.dtype == torch.uint8:
        return to_float01(batch)
    return batch.float()


def _rep(contrast_on: str, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """What the margins act on: ``h``, the relaxed ``z``, or ``p =
    sigmoid(h)`` (the bit probabilities at unit temperature)."""
    return {"h": lambda: h, "z": lambda: z,
            "p": lambda: torch.sigmoid(h)}[contrast_on]()


def _forward(model, x, temperature, hard, noise: Noise, k: int,
             deterministic: bool, noise_ratio: float):
    return model(x, temperature, hard, noise_ratio,
                 deterministic=deterministic, generator=noise.generator(k),
                 u=noise.u(k),
                 dropout_seed=None if deterministic else noise.dropout_seed(k),
                 rows=noise.rows)


def _encode_h(model, cfg, x, temperature, hard, noise: Noise, k: int,
              deterministic: bool):
    """``(h_seq, z_seq)`` of the encoder half alone (the context-free
    passes need nothing of the decoder)."""
    scale = cfg.noise_ratio if model.cfg.has_noise_ratio else 1.0
    _, h, z = model._encode_to_latent(
        x, temperature, hard, scale, noise.generator(k), noise.u(k),
        dropout_seed=None if deterministic else noise.dropout_seed(k),
        rows=noise.rows)
    return h, z


def pair_objective(model: Seq2SeqBinaryVAE, cfg: TrainConfig, batch,
                   temperature, hard: bool, noise: Noise,
                   deterministic: bool):
    """Shared loss of the contrastive and triplet objectives
    (``svtpu/training/trainer.py:78-237``).

    ``batch``: ``[B, 2, S, H, W, C]``, member 0/1 of the pair per state;
    both members run through the model as one ``[2B, S, ...]`` batch.
    Returns ``(total, metrics)``.
    """
    x = _prep(batch)
    B, S = x.shape[0], x.shape[2]
    extra_metrics = {}
    xm = x.transpose(0, 1).reshape((2 * B, S) + tuple(x.shape[3:]))
    out = _forward(model, xm, temperature, hard, noise, 0, deterministic,
                   cfg.noise_ratio)
    recon = losses.recon_mse(out.x_recon, xm)
    # The reference feeds the binarized z_seq to the Bernoulli KL.
    kl = losses.kl_binary_concrete(out.z_seq, p=cfg.bernoulli_p)
    rep = _rep(cfg.contrast_on, out.h_seq, out.z_seq)
    h0, h1 = rep[:B], rep[B:]

    def ctxfree(k):
        """A T=1 encode of the identical frames (what the probes
        measure)."""
        xf = xm.reshape((2 * B * S, 1) + tuple(xm.shape[2:]))
        return _encode_h(model, cfg, xf, temperature, hard, noise, k,
                         deterministic)

    if cfg.objective == "contrastive":
        sim = losses.contrastive(h0, h1, 0.0, margin=cfg.margin)
        # Adjacent-state dissimilarity on member 0.
        dis = losses.contrastive(h0[:, :-1], h0[:, 1:], 1.0,
                                 margin=cfg.margin)
        aux = sim + dis
        if cfg.contextfree_contrast:
            hf, zf = ctxfree(1)
            repf = _rep(cfg.contrast_on, hf, zf).reshape(2, B, S, -1)
            f0, f1 = repf[0], repf[1]
            aux = 0.5 * aux + 0.5 * (
                losses.contrastive(f0, f1, 0.0, margin=cfg.margin)
                + losses.contrastive(f0[:, :-1], f0[:, 1:], 1.0,
                                     margin=cfg.margin))
        aux_name = "contrast_loss"
    elif cfg.objective == "triplet":
        # anchor = state t (member 0), positive = state t (member 1),
        # negative = state t+1 (member 0); (B, S-1) flattened.
        if cfg.triplet_distance == "js":
            z0, z1 = out.z_seq[:B], out.z_seq[B:]
            L = z0.shape[-1]
            aux = losses.triplet_js(z0[:, :-1].reshape(-1, L),
                                    z1[:, :-1].reshape(-1, L),
                                    z0[:, 1:].reshape(-1, L),
                                    margin=cfg.margin)
        else:
            L = h0.shape[-1]
            aux = losses.triplet_margin(h0[:, :-1].reshape(-1, L),
                                        h1[:, :-1].reshape(-1, L),
                                        h0[:, 1:].reshape(-1, L),
                                        margin=cfg.margin, swap=True)
        if cfg.triplet_pull:
            # anchor<->positive pull on the unit-temperature probabilities.
            pull = losses.contrastive(torch.sigmoid(out.h_seq[:B]),
                                      torch.sigmoid(out.h_seq[B:]), 0.0,
                                      margin=cfg.margin)
            aux = aux + cfg.triplet_pull * pull
            extra_metrics = {"pull_loss": pull}
        if cfg.triplet_push:
            # An absolute (anchor, negative) margin in p-space.
            pa = torch.sigmoid(out.h_seq[:B])
            push = losses.contrastive(pa[:, :-1], pa[:, 1:], 1.0,
                                      margin=cfg.margin)
            if cfg.contextfree_contrast:
                hf, _ = ctxfree(2)
                pf = torch.sigmoid(hf.reshape(2, B, S, hf.shape[-1]))
                push = 0.5 * push + 0.5 * losses.contrastive(
                    pf[0][:, :-1], pf[0][:, 1:], 1.0, margin=cfg.margin)
                if cfg.triplet_pull:
                    pullf = losses.contrastive(pf[0], pf[1], 0.0,
                                               margin=cfg.margin)
                    aux = aux + cfg.triplet_pull * pullf
                    extra_metrics = {**extra_metrics, "pullf_loss": pullf}
            aux = aux + cfg.triplet_push * push
            extra_metrics = {**extra_metrics, "push_loss": push}
        aux_name = "triplet_loss"
    else:
        raise ValueError(cfg.objective)

    total = recon + cfg.beta_kl * kl + cfg.alpha * aux
    if cfg.l1_logits:
        # L1 on the binarization logits: sum over latent, mean over the
        # rest (the KL's reduction).
        l1 = cfg.l1_logits * out.h_seq.abs().sum(-1).mean()
        total = total + l1
    metrics = {"total_loss": total, "recon_loss": recon, "kl_loss": kl,
               aux_name: aux, **extra_metrics}
    if cfg.l1_logits:
        metrics["l1_loss"] = l1
    return total, metrics


def simple_objective(model: Seq2SeqBinaryVAE, cfg: TrainConfig, batch,
                     temperature, hard: bool, noise: Noise,
                     deterministic: bool, mask=None):
    """Bare recon + KL loss on whole state segments
    (``svtpu/training/trainer.py:240-270``). ``batch``: ``[B, T, H, W, C]``;
    ``mask``: optional ``[B, T]`` validity (padded steps do not count). The
    noise ratio is the model's default, as in ``svtpu``."""
    x = _prep(batch)
    out = _forward(model, x, temperature, hard, noise, 0, deterministic,
                   0.1)
    if mask is None:
        recon = losses.recon_mse(out.x_recon, x)
        kl = losses.kl_binary_concrete(out.logits, p=cfg.bernoulli_p)
    else:
        m = mask.float()                                     # [B, T]
        per_frame = ((out.x_recon - x) ** 2).mean(
            dim=tuple(range(2, x.ndim)))                     # [B, T]
        count = torch.clamp(m.sum(), min=1.0)
        recon = (per_frame * m).sum() / count
        q = torch.sigmoid(out.logits).clamp(1e-8, 1 - 1e-8)
        log_p = math.log(cfg.bernoulli_p)
        log_1mp = math.log1p(-cfg.bernoulli_p)
        kl_bt = (q * (torch.log(q + 1e-8) - log_p)
                 + (1 - q) * (torch.log(1 - q + 1e-8) - log_1mp)).sum(-1)
        kl = (kl_bt * m).sum() / count
    total = recon + cfg.beta_kl * kl
    return total, {"total_loss": total, "recon_loss": recon, "kl_loss": kl}


class Trainer(GraphedEncodes):
    """RBVAE trainer, on one device or over a mesh of ranks.

    Args:
      model_cfg / train_cfg: typed configs.
      store: FrameStore or EmbeddingStore.
      splits: SplitIndices of the video.
      flags: transition flags (for the consistency labels).
      mesh: a ``parallel.mesh.Mesh``; by default ``make_mesh`` of the
        config's ``mesh_shape`` and ``mesh_axes``, which is one rank without
        a process group. Every rank of the process group builds the trainer.
      seed: overrides ``train_cfg.seed``.
      labels_by_index: an explicit frame id → state id map in place of the
        flags' labels.
      device: CUDA unless ``"cpu"`` is asked for (raises without a card);
        under NCCL, this rank's card. On a CUDA device with no "model" mesh
        axis every train step is a replay of a CUDA graph (``graph_route``),
        and so is every probe encode after its key's first
        (``encode_frames``).
    """

    def __init__(self, model_cfg: RBVAEConfig, train_cfg: TrainConfig,
                 store, splits: SplitIndices, flags: Sequence[int], *,
                 mesh=None, seed: Optional[int] = None,
                 labels_by_index: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            train_cfg.mesh_shape, train_cfg.mesh_axes)
        # Batches split over the data axis: round the batch size up to a
        # multiple, and under lr_scaling="linear" scale the learning rate
        # with it (svtpu/training/trainer.py:299-315).
        ndata = self.mesh.size("data")
        if train_cfg.batch_size % ndata:
            new_bs = -(-train_cfg.batch_size // ndata) * ndata
            new_lr = (train_cfg.learning_rate * new_bs / train_cfg.batch_size
                      if train_cfg.lr_scaling == "linear"
                      else train_cfg.learning_rate)
            train_cfg = dataclasses.replace(
                train_cfg, batch_size=new_bs, learning_rate=new_lr)
        self.mcfg = model_cfg
        self.cfg = train_cfg
        self.store = store
        self.splits = splits
        self.flags = list(flags)
        self.labels_by_index = labels_by_index
        self.seed = train_cfg.seed if seed is None else seed
        # This rank's rows [lo, hi) of every global batch, and their rows
        # of the [2B, S] pair pass; all rows where the data axis has no
        # group.
        self._data_group = self.mesh.group("data")
        b = train_cfg.batch_size // ndata
        self._lo = self.mesh.rank("data") * b
        self._hi = self._lo + b
        self._rows = None
        if self._data_group is not None:
            mine = torch.arange(self._lo, self._hi)
            self._rows = GlobalRows(
                torch.cat([mine, mine + train_cfg.batch_size]).to(
                    self.device), 2 * train_cfg.batch_size)
        self.writer = MetricsWriter(train_cfg.log_dir if distributed.is_main()
                                    else None)
        self._epoch_metric_names: list = []
        # Step s of the run draws from batch_seed(_base_seed, s); a
        # restart with restart_reroll="stream" moves it.
        self._base_seed = self.seed + 1
        # The temperature floor; the trap guard raises it.
        self._temp_floor = float(train_cfg.final_temperature)
        # The step reads its temperature here, a float64 scalar on the
        # device: cast to the compute dtype it rounds the host float as
        # torch.full of it would. The step's generators are made once.
        self._temp = torch.zeros((), dtype=torch.float64, device=self.device)
        self._gens = StepGenerators(self.device)
        # Adam is capturable on the card, on every route there, so that the
        # graph and the eager step do the same arithmetic (its bias
        # corrections on the device); the CPU refuses it.
        self._capturable = self.device.type == "cuda"
        self._graphed = graph_route(self.device, self.mesh) == "graph"

        if train_cfg.objective != "simple":
            self.train_batcher = PairBatcher(
                store, splits.train, train_cfg.batch_size, seed=self.seed)
            self.val_batcher = PairBatcher(
                store, splits.val, train_cfg.batch_size, seed=self.seed + 1,
                shuffle=False)

        # The frame bank on the device: when the store fits, it goes up
        # once and the steps take row indices, gathered on the device.
        self._bank = None
        if train_cfg.objective != "simple" and train_cfg.stage_frames:
            nbytes = _staging_nbytes(store)
            if nbytes > 0 and (train_cfg.stage_frames != "auto"
                               or nbytes <= 2 * 1024**3):
                self._bank = torch.from_numpy(store.array).to(self.device)

    # ------------------------------------------------------------------ init

    def init_state(self, seed_offset: int = 0) -> TrainState:
        """A model drawn from ``seed + seed_offset``, with one bias per
        LSTM layer, and a fresh Adam (optax's defaults). On a mesh with a
        process group the parameters are rank 0's, and a "model" axis
        shards the projections."""
        model = Seq2SeqBinaryVAE(
            self.mcfg, device=self.device,
            generator=torch.Generator().manual_seed(self.seed + seed_offset))
        if self.mesh.device_mesh is not None:
            distributed.broadcast_(list(model.state_dict().values()),
                                   src=int(self.mesh.devices.flat[0]))
        fold_lstm_biases(model)
        if "model" in self.mesh.axis_names:
            parallelize_rbvae(model, self.mesh)
        params = [p for p in model.parameters() if p.requires_grad]
        groups = [{"params": [p for p in params
                              if not distributed.is_dtensor(p)]}]
        sharded = [p for p in params if distributed.is_dtensor(p)]
        if sharded:
            # The multi-tensor Adam on the card refuses a list that mixes
            # DTensors and tensors: the sharded ones form a group of their
            # own, stepped as one list.
            groups.append({"params": sharded})
        opt = torch.optim.Adam(groups, lr=self.cfg.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8,
                               capturable=self._capturable)
        return TrainState(step=0, model=model, optimizer=opt)

    # ----------------------------------------------------------- train step

    def _objective(self):
        if self.cfg.objective in ("contrastive", "triplet"):
            return pair_objective
        return simple_objective

    def _batch(self, batch: torch.Tensor) -> torch.Tensor:
        """Row indices → frames from the bank; frames pass through."""
        return batch if self._bank is None else self._bank[batch.long()]

    def _ctxfree_h_scale(self, model) -> float:
        """Mean context-free |h| on up to 64 val frames: the quantity whose
        ratio to the temperature marks the late-anneal gradient trap."""
        idx = np.asarray([i for s in self.splits.val for i in s][:64])
        with torch.no_grad():
            if self._bank is not None:
                x = self._bank[torch.from_numpy(self.store.rows(idx))
                               .to(self.device)]
            else:
                x = torch.from_numpy(self.store.gather(idx)).to(self.device)
            _, h, _ = model._encode_to_latent(_prep(x)[:, None], 1.0, False,
                                              0.0, None, None)
            return float(h[:, 0].abs().mean())

    def _step_body(self, model, optimizer, batch: torch.Tensor
                   ) -> torch.Tensor:
        """The device work of one train step, one definition for the eager
        step and its CUDA graph (``svtpu``'s ``_train_step_body``): the
        objective at the temperature in ``self._temp`` with the generators
        of ``self._gens``, as ``_step`` set them for the step, the backward,
        the gradients' mean over the data axis, Adam. Returns the step's
        metrics (this rank's) as one float32 vector on the device, in
        ``_epoch_metric_names`` order."""
        noise = Noise(self._gens.key, self.device, rows=self._rows,
                      generators=self._gens)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = self._objective()(model, self.cfg,
                                           self._batch(batch), self._temp,
                                           False, noise, deterministic=False)
        total.backward()
        distributed.all_reduce_mean_(
            [p.grad for p in model.parameters() if p.grad is not None],
            self._data_group, self.mesh.size("data"))
        optimizer.step()
        self._epoch_metric_names = sorted(metrics)
        return torch.stack([metrics[k].detach().float()
                            for k in self._epoch_metric_names])

    def _step(self, state: TrainState, batch: torch.Tensor):
        """One optimizer step on this rank's rows of a batch: the step
        counter, temperature and seeds on the host, then the body, eagerly
        or as a replay of the state's graph. Returns the metric vector (on
        the graph route the graph's, which the next step overwrites) and the
        temperature (a host float)."""
        cfg = self.cfg
        state.step += 1
        temp = max(temperature_schedule(
            state.step, cfg.init_temperature, cfg.final_temperature,
            cfg.anneal_rate, cfg.num_steps_to_update), self._temp_floor)
        self._gens.seed(batch_seed(self._base_seed, state.step))
        self._temp.fill_(temp)
        if not self._graphed:
            return self._step_body(state.model, state.optimizer, batch), temp
        if state.graph is None:
            state.graph = StepGraph(
                functools.partial(self._step_body, state.model,
                                  state.optimizer), self._gens.all,
                self.device)
        return state.graph(batch), temp

    def _train_step(self, state: TrainState, batch: torch.Tensor):
        """``_step`` with the metrics by name (this rank's, tensors on the
        device, not read back) and the temperature (a host float)."""
        vec, temp = self._step(state, batch)
        return dict(zip(self._epoch_metric_names, vec.clone())), temp

    def _data_mean(self, vec: torch.Tensor) -> torch.Tensor:
        """A metric vector averaged over the data axis."""
        distributed.all_reduce_mean_([vec], self._data_group,
                                     self.mesh.size("data"))
        return vec

    def _upload_epoch(self, epoch: int) -> Optional[torch.Tensor]:
        """This rank's rows of the epoch's stacked ``[steps, B, 2, S]`` row
        indices, on the device (one copy); ``None`` for an empty epoch."""
        with span("svtpu.train.data"):
            batches = list(self.train_batcher.epoch_indices(epoch))
            if not batches:
                return None
            idx = np.stack(batches)[:, self._lo:self._hi]
            return torch.from_numpy(idx.astype(np.int64)).to(self.device)

    def _fused_steps(self, state: TrainState, idx: torch.Tensor):
        """Every step of a staged epoch, with no wait for the device: the
        per-metric sums stay on it (a vector in ``_epoch_metric_names``
        order). Returns the sums and the sum of the steps' temperatures."""
        sums, temps = None, 0.0
        with span("svtpu.train.steps"):
            for i in range(len(idx)):
                vec, temp = self._step(state, idx[i])
                sums = vec.clone() if sums is None else sums + vec
                temps += temp
        return sums, temps

    def _fused_epoch(self, state: TrainState, epoch: int):
        """A staged epoch: indices up once, the steps, one readback.
        Returns the epoch's mean metrics and the frames it trained on."""
        idx = self._upload_epoch(epoch)
        if idx is None:
            return {}, 0
        vec, temps = self._fused_steps(state, idx)
        vec = self._data_mean(vec)
        with span("svtpu.train.readback.wait"):
            vec = vec.cpu()
        sums = dict(zip(self._epoch_metric_names, vec.double().tolist()))
        sums["temperature"] = temps
        return ({k: v / len(idx) for k, v in sums.items()},
                len(idx) * self.cfg.batch_size * int(np.prod(idx.shape[2:])))

    def _per_step_epoch(self, state: TrainState, epoch: int,
                        log_every: int = 0):
        """An epoch one step at a time, batches prefetched to the device
        (row indices with the bank, frames without), every step's metrics
        read back. Returns the epoch's mean metrics and its frames."""
        sums, nb, frames = {}, 0, 0
        lo, hi = self._lo, self._hi
        if self._bank is not None:
            batches = (ix[lo:hi]
                       for ix in self.train_batcher.epoch_indices(epoch))
        else:
            batches = (self.store.gather(ix[lo:hi]) for ix in
                       self.train_batcher.epoch_frame_indices(epoch))
        for b in prefetch_to_device(batches, self.device):
            vec, temp = self._step(state, b)
            nb += 1
            frames += self.cfg.batch_size * int(np.prod(b.shape[1:3]))
            vec = self._data_mean(vec.clone())
            m = dict(zip(self._epoch_metric_names,
                         vec.cpu().double().tolist()))
            m["temperature"] = temp
            if log_every and nb % log_every == 0:
                self.writer.scalars("Batch", m, state.step)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
        return {k: v / max(nb, 1) for k, v in sums.items()}, frames

    @torch.no_grad()
    def _val_step(self, model, batch: torch.Tensor, key: int) -> dict:
        """Val metrics of one batch: contrastive validates with ``hard`` and
        a coefficient-normalised total, triplet with neither (the
        reference's two trainers)."""
        cfg = self.cfg
        contrastive = cfg.objective == "contrastive"
        _, m = self._objective()(model, cfg, self._batch(batch),
                                 cfg.final_temperature, contrastive,
                                 Noise(key, self.device), deterministic=True)
        if contrastive:
            coeff = 1.0 + cfg.beta_kl + cfg.alpha
            m["total_loss"] = (m["recon_loss"] + cfg.beta_kl * m["kl_loss"]
                               + cfg.alpha * m["contrast_loss"]) / coeff
        return m

    def _val_epoch(self, model, vib: Optional[torch.Tensor],
                   epoch: int) -> dict:
        """The val set's mean metrics under ``epoch``'s key: from ``vib``,
        its stacked row indices on the device (a fused run: one readback),
        else from batches copied up and read back one at a time."""
        with span("svtpu.train.val"):
            vkey = batch_seed(self._base_seed, 10_000_000 + epoch)
            if vib is not None:
                vbatches = iter(vib)
            else:
                vbatches = (torch.from_numpy(b).to(self.device) for b in (
                    self.val_batcher.epoch_indices(0)
                    if self._bank is not None else self.val_batcher.epoch(0)))
            vsums, vn, names = None, 0, []
            for b in vbatches:
                m = self._val_step(model, b, vkey)
                names = sorted(m)
                vec = torch.stack([m[k].float() for k in names])
                vn += 1
                if vib is None:
                    vec = vec.cpu().double()   # one readback a batch
                vsums = vec if vsums is None else vsums + vec
            if vsums is None:
                return {}
            return {k: v / max(vn, 1) for k, v in
                    zip(names, vsums.cpu().double().tolist())}

    def _full_tree(self, state: TrainState) -> dict:
        """The checkpoint tree, sharded tensors whole (every rank calls
        it)."""
        return {"model": full_state_dict(state.model),
                "optimizer": full_optimizer_state(
                    state.optimizer.state_dict())}

    def _load_full(self, state: TrainState, tree: dict) -> None:
        """Load a checkpoint tree of whole tensors into this rank's
        blocks."""
        name = {id(p): n for n, p in state.model.named_parameters()}
        names = [name[id(p)] for g in state.optimizer.param_groups
                 for p in g["params"]]
        model_sd, opt_sd = local_state(state.model, tree["model"],
                                       tree["optimizer"], names)
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(opt_sd)
        # A checkpoint names the device it was saved from in ``capturable``;
        # Adam here keeps this trainer's, and a graph of the old moments is
        # stale.
        for group in state.optimizer.param_groups:
            group["capturable"] = self._capturable
        if self._capturable:
            for s in state.optimizer.state.values():
                s["step"] = s["step"].to(self.device, torch.float32)
        state.graph = None

    # ------------------------------------------------------------- encoding

    def encode_frames(self, model, frames: np.ndarray, temperature: float,
                      hard: bool = True, noise: bool = True, seed: int = 0,
                      chunk: int = 128, from_bank: bool = False) -> np.ndarray:
        """Batched single-frame encode → codes ``[N, latent]``
        (``encode_chunks``) at the eval noise ratio. ``from_bank=True``:
        ``frames`` are row indices into the device bank, gathered on the
        device. On the graph route (``_graphed``) each (model, key) is a
        CUDA graph whose temperature is written at every call."""
        cfg = self.cfg
        enc_noise = (cfg.eval_noise_ratio if cfg.eval_noise_ratio is not None
                     else cfg.noise_ratio)
        use_bank = from_bank and self._bank is not None
        return encode_chunks(model, frames, self._chunk_prep(use_bank),
                             temperature, hard, noise, enc_noise, seed,
                             chunk, self.encode_graphs())

    def _chunk_prep(self, use_bank: bool):
        """A probe chunk on the card → the model's input: row indices
        gathered from the bank (``svtpu``'s ``enc_rows``), or frames."""

        def prep(x):
            return _prep(self._bank[x.long()] if use_bank else x)

        return prep

    def _val_codes(self, model, val_idx, temperature, noise: bool,
                   seed: int) -> np.ndarray:
        """Codes of the validation frames: row indices through the bank
        when there is one, else frames gathered on the host."""
        if self._bank is not None:
            rows = self.store.rows(np.asarray(val_idx))
            return self.encode_frames(model, rows, temperature, hard=True,
                                      noise=noise, seed=seed, from_bank=True)
        frames = self.store.gather(np.asarray(val_idx))
        return self.encode_frames(model, frames, temperature, hard=True,
                                  noise=noise, seed=seed)

    def _val_labels(self, val_idx):
        if self.labels_by_index is not None:
            labels = np.asarray([self.labels_by_index[i] for i in val_idx])
            return labels, int(max(self.labels_by_index.values())) + 1
        labels = np.asarray([assign_label(i, self.flags) for i in val_idx])
        return labels, len(self.flags) + 1

    def state_consistency(self, model, temperature: float,
                          noise: bool = True, seed: int = 0):
        """Weighted modal-code match over the validation frames."""
        val_idx = [i for s in self.splits.val for i in s]
        if not val_idx:
            return 0.0, []
        codes = self._val_codes(model, val_idx, temperature, noise, seed)
        return modal_consistency(codes, *self._val_labels(val_idx))

    def state_separation(self, model, temperature: float, seed: int = 0):
        """``(separation, det_consistency, ham_vector)`` from one
        deterministic encode of the validation frames: the
        ``sep_aggregate`` of the adjacent-state Hamming distances of the
        modal codes, the noise-off consistency, and the per-pair vector."""
        val_idx = [i for s in self.splits.val for i in s]
        if not val_idx:
            return 0.0, 0.0, np.zeros(0)
        codes = self._val_codes(model, val_idx, temperature, noise=False,
                                seed=seed)
        labels, num_states = self._val_labels(val_idx)
        det_w, _ = modal_consistency(codes, labels, num_states)
        ham = adjacent_hamming(modal_codes(codes, labels, num_states))
        if len(ham) == 0:
            sep = 0.0
        elif self.cfg.sep_aggregate == "min":
            sep = float(ham.min())
        else:
            sep = float(ham.mean())
        return sep, float(det_w), ham

    # ------------------------------------------------------------ main loop

    def train_simple(self, state_segments, num_epochs: Optional[int] = None,
                     temperature: float = 0.5) -> dict:
        """Bare recon + KL loop over whole state segments at a fixed
        temperature; step ``s`` (0-based, as ``svtpu`` folds it here) draws
        from ``batch_seed(seed + 1, s)``. A step is one segment, so on a
        mesh every rank trains on the whole of it."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        batcher = SegmentBatcher(self.store, state_segments, seed=self.seed)
        state = self.init_state()
        history = {"train_losses": []}
        for epoch in range(num_epochs):
            last = {}
            for batch, mask in batcher.epoch(epoch):
                b = torch.from_numpy(batch).to(self.device)
                m = torch.from_numpy(mask).to(self.device)
                noise = Noise(batch_seed(self.seed + 1, state.step),
                              self.device)
                state.optimizer.zero_grad(set_to_none=True)
                total, metrics = simple_objective(
                    state.model, cfg, b, temperature, False, noise,
                    deterministic=False, mask=m)
                total.backward()
                state.optimizer.step()
                state.step += 1
                last = {k: float(v.detach()) for k, v in metrics.items()}
            history["train_losses"].append(last)
        history["final_state"] = state
        return history

    def train(self, num_epochs: Optional[int] = None,
              save_path: Optional[str] = None,
              log_every: int = 0, resume: bool = False) -> dict:
        """Run the training loop.

        ``resume=True`` restores the ``latest`` checkpoint from
        ``save_path`` and continues from its epoch and global step. A
        SIGUSR1 during training saves ``latest`` at the next epoch
        boundary."""
        cfg = self.cfg
        if cfg.objective == "simple":
            raise ValueError("use train_simple() for the simple objective")
        num_epochs = num_epochs or cfg.num_epochs
        state = self.init_state()
        # A fused epoch needs the bank (same-shape index batches) and no
        # per-batch logging.
        fused = cfg.fused_epoch and self._bank is not None and not log_every

        maximize = cfg.select_by != "val_loss"
        ckpt = (BestCheckpointer(save_path, mode="max" if maximize else "min")
                if save_path else None)
        self._base_seed = self.seed + 1

        worst_key = [-np.inf, -np.inf, -np.inf, -np.inf]
        history = {"train_losses": [], "val_losses": [], "best_epoch": 0,
                   "best_metric": -np.inf if maximize else np.inf,
                   "best_key": list(worst_key)}
        start_epoch = 0
        if resume and ckpt and ckpt.exists("latest"):
            tree, meta = ckpt.restore("latest")
            self._load_full(state, tree)
            start_epoch = int(meta["epoch"]) + 1
            history["best_metric"] = float(meta.get("best_metric",
                                                    history["best_metric"]))
            if "best_key" in meta:
                history["best_key"] = [float(x) for x in meta["best_key"]]
            elif np.isfinite(history["best_metric"]):
                history["best_key"] = [
                    (1.0 if maximize else -1.0) * history["best_metric"],
                    np.inf, np.inf, np.inf]
            if np.isfinite(history["best_metric"]):
                ckpt.best_metric = history["best_metric"]
                ckpt.best_key = tuple(history["best_key"])
            # The temperature schedule resumes where it left off.
            state.step = int(meta.get("global_step", 0))

        melk_requested = [False]
        try:
            prev_handler = signal.signal(
                signal.SIGUSR1, lambda *_: melk_requested.__setitem__(0, True))
        except (ValueError, OSError):      # not the main thread
            prev_handler = None

        t0 = time.time()
        frames_seen = 0
        vib = None
        if fused:
            # The val set is fixed across epochs and restarts: its stacked
            # row indices go up once.
            vb = list(self.val_batcher.epoch_indices(0))
            if vb:
                vib = torch.from_numpy(np.stack(vb).astype(np.int64)).to(
                    self.device)

        restarts = 0
        run_max_sep = 0.0
        next_check = (start_epoch + cfg.restart_check_epoch
                      if cfg.restart_check_epoch else None)
        history["restarts"] = []

        # Probe state carried across epochs that are not probed.
        metric = history["best_metric"]
        sel_key = tuple(history["best_key"])
        ham = np.zeros(0, dtype=np.int64)
        det_w, sep_mean = 0.0, 0.0

        for epoch in range(start_epoch, num_epochs):
            with span("svtpu.train.epoch"), \
                    contextlib.ExitStack() as epoch_end:
                # ---- train
                if fused:
                    train_losses, frames = self._fused_epoch(state, epoch)
                else:
                    train_losses, frames = self._per_step_epoch(state, epoch,
                                                                log_every)
                frames_seen += frames
                # Val, probes, the metrics writer, selection, checkpoint
                # and restart: what runs between two epochs' steps.
                epoch_end.enter_context(span("svtpu.train.epoch_end"))

                # ---- validate every cfg.val_every epochs, and always on the
                # final epoch and the restart-check epoch.
                probe = (cfg.val_every <= 1
                         or (epoch - start_epoch) % cfg.val_every == 0
                         or epoch == num_epochs - 1
                         or (next_check is not None
                             and restarts < cfg.max_restarts
                             and epoch + 1 == next_check))
                val_losses = {}
                better = False
                if probe:
                    val_losses = self._val_epoch(state.model, vib, epoch)
                    with span("svtpu.train.probe"):
                        score, per_state = self.state_consistency(
                            state.model, cfg.final_temperature, seed=epoch)
                    val_losses["consistency_score"] = float(score)
                    with span("svtpu.train.probe"):
                        sep, det_w, ham = self.state_separation(
                            state.model, cfg.final_temperature)
                    sep_mean = float(ham.mean()) if len(ham) else 0.0
                    val_losses["state_separation"] = sep
                    val_losses["sep_mean"] = sep_mean
                    val_losses["sep_min"] = \
                        float(ham.min()) if len(ham) else 0.0
                    for i, h in enumerate(ham):
                        val_losses[f"sep_pair_{i}"] = float(h)
                    val_losses["det_consistency_score"] = det_w
                    val_losses["combined_score"] = float(score) * min(
                        sep / cfg.sep_target, 1.0)
                    for i, p in enumerate(per_state):
                        val_losses[f"state_{i}_consistency"] = float(p)

                    # Trap guard: keep the measured |h|/T at or below the band
                    # by raising the temperature floor as |h| grows.
                    if cfg.trap_guard_ratio > 0:
                        abs_h = self._ctxfree_h_scale(state.model)
                        val_losses["ctxfree_abs_h"] = abs_h
                        needed = abs_h / cfg.trap_guard_ratio
                        if needed > self._temp_floor:
                            self._temp_floor = needed
                            ev = history.setdefault(
                                "trap_guard", {"first_raise_epoch": epoch,
                                               "raises": 0})
                            ev["raises"] += 1
                            ev["floor"] = float(needed)
                            ev["abs_h"] = abs_h
                            ev["epoch"] = epoch

                self.writer.scalars("Epoch/Train", train_losses, epoch)
                if probe:
                    self.writer.scalars("Epoch/Val", val_losses, epoch)
                    metric = val_losses[{
                        "consistency": "consistency_score",
                        "separation": "state_separation",
                        "combined": "combined_score",
                        "val_loss": "total_loss"}[cfg.select_by]]
                    # Lexicographic selection: the metric, then det
                    # consistency, mean separation and the epoch break ties.
                    sign = 1.0 if maximize else -1.0
                    sel_key = (sign * metric, det_w, sep_mean, epoch)
                    better = sel_key > tuple(history["best_key"])
                if better:
                    history["best_metric"] = metric
                    history["best_key"] = list(sel_key)
                    history["best_epoch"] = epoch
                    history["best_ham_vector"] = [int(h) for h in ham]
                periodic = (cfg.latest_every > 0
                            and (epoch - start_epoch) % cfg.latest_every == 0)
                if ckpt and (better or melk_requested[0] or periodic
                             or epoch == num_epochs - 1):
                    tree = self._full_tree(state)      # a collective under TP
                    if distributed.is_main():
                        ckpt.save(
                            tree,
                            epoch=epoch, metric=metric, sel_key=sel_key,
                            extra={"select_by": cfg.select_by,
                                   "best_metric": history["best_metric"],
                                   "best_key": list(history["best_key"]),
                                   "ham_vector": [int(h) for h in ham],
                                   "global_step": state.step})
                    melk_requested[0] = False
                history["train_losses"].append(train_losses)
                history["val_losses"].append(val_losses)
                # SVTPU_EPOCH_LOG=N prints a heartbeat every N epochs.
                hb = int(os.environ.get("SVTPU_EPOCH_LOG", "0") or 0)
                if hb and distributed.is_main() and (
                        epoch % hb == 0 or epoch == num_epochs - 1):
                    vals = (f"cons {val_losses['consistency_score']:.3f} "
                            f"det {val_losses['det_consistency_score']:.3f} "
                            f"sep {val_losses['state_separation']:.2f} "
                            if probe else "(no probe) ")
                    print(f"[epoch {epoch}] "
                          f"train {train_losses.get('total_loss', 0):.4f} "
                          f"{vals}"
                          f"best {history['best_metric']:.4f}"
                          f"@{history['best_epoch']}", flush=True)

                # ---- auto-restart: a run that has not left the collapsed
                # basin by the check epoch re-rolls its init within the same
                # budget.
                sep_check = (float(ham.min()) if len(ham) else 0.0) \
                    if cfg.restart_on == "min" else sep_mean
                if probe:
                    run_max_sep = max(run_max_sep, sep_check)
                if (next_check is not None and restarts < cfg.max_restarts
                        and epoch + 1 >= next_check
                        and run_max_sep < cfg.restart_min_sep):
                    restarts += 1
                    state = self.init_state(seed_offset=1000 * restarts)
                    if cfg.restart_reroll == "stream":
                        # Re-roll the train pairs and the noise stream too; val
                        # stays fixed so the probes stay comparable.
                        self.train_batcher = PairBatcher(
                            self.store, self.splits.train, cfg.batch_size,
                            seed=self.seed + 1000 * restarts)
                        self._base_seed = self.seed + 1 + 1000 * restarts
                    run_max_sep = 0.0
                    self._temp_floor = float(cfg.final_temperature)
                    history.pop("trap_guard", None)
                    next_check = epoch + 1 + cfg.restart_check_epoch
                    # The re-rolled run replaces the failed one and its best.
                    history["best_metric"] = -np.inf if maximize else np.inf
                    history["best_key"] = list(worst_key)
                    history["best_epoch"] = epoch + 1
                    metric = history["best_metric"]
                    sel_key = tuple(worst_key)
                    ham = np.zeros(0, dtype=np.int64)
                    det_w, sep_mean = 0.0, 0.0
                    if ckpt:
                        ckpt.best_metric = None
                        ckpt.best_key = None
                    history["restarts"].append(
                        {"epoch": epoch, "restart": restarts,
                         "seed_offset": 1000 * restarts})
                    print(f"[epoch {epoch}] {cfg.restart_on} separation "
                          f"{sep_check:.2f} < "
                          f"{cfg.restart_min_sep} after "
                          f"{cfg.restart_check_epoch} epochs — restart "
                          f"{restarts}/{cfg.max_restarts} with seed offset "
                          f"{1000 * restarts}", flush=True)

        if prev_handler is not None:
            signal.signal(signal.SIGUSR1, prev_handler)
        history["wall_time_s"] = time.time() - t0
        history["frames_seen"] = frames_seen
        # The run's step graph goes with it (its memory pool holds the
        # step's activations); a caller that steps the final state on
        # captures anew.
        state.graph = None
        self.drop_graphs()
        history["final_state"] = state
        self.writer.close()
        return history


def modal_consistency(codes: np.ndarray, labels: np.ndarray,
                      num_states: int):
    """Fraction of codes equal to each state's modal code, weighted by
    state size."""
    pct, counts = [], []
    bits = np.asarray(codes) > 0.5
    for s in range(num_states):
        mask = labels == s
        counts.append(int(mask.sum()))
        if not mask.any():
            pct.append(0.0)
            continue
        vecs = bits[mask]
        uniq, cnt = np.unique(vecs, axis=0, return_counts=True)
        modal = uniq[np.argmax(cnt)]
        pct.append(float(np.mean(np.all(vecs == modal, axis=1))))
    total = sum(counts)
    weighted = float(np.dot(pct, counts) / total) if total else 0.0
    return weighted, pct
