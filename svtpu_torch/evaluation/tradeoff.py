"""Consistency-vs-separation trade-off over a sweep's checkpoints
(``svtpu/evaluation/tradeoff.py``).

Selecting models by within-state consistency alone is blind to all states
collapsing onto one code, so every saved checkpoint is re-evaluated on one
split for the joint (consistency, deterministic adjacent-state separation)
table and scatter chart. Checkpoint directories are the port's
``BestCheckpointer`` directories (``best.pt`` and ``best.json``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from svtpu_torch.config import rbvae_variant
from svtpu_torch.evaluation.common import RBVAEBundle, labels_of
from svtpu_torch.evaluation.hamming import adjacent_hamming, modal_codes
from svtpu_torch.training.trainer import modal_consistency


@dataclasses.dataclass
class TradeoffPoint:
    run: str
    consistency: float          # eval protocol: hard, temp, noise on
    separation: float           # deterministic modal adjacent Hamming, bits
    det_consistency: float      # hard, noise off (upper bound)
    config: dict


def evaluate_checkpoint(bundle: RBVAEBundle, frames: np.ndarray,
                        frame_indices: Sequence[int], flags: Sequence[int],
                        temperature: float = 0.2, noise_ratio: float = 0.1,
                        seed: int = 0):
    """(stochastic consistency, deterministic separation, deterministic
    consistency) for one model on one frame set."""
    labels, num_states = labels_of(frame_indices, flags)
    codes = bundle.encode(frames, temperature=temperature, hard=True,
                          noise=True, noise_ratio=noise_ratio, seed=seed)
    w, _ = modal_consistency(codes, labels, num_states)
    det = bundle.encode(frames, temperature=temperature, hard=True,
                        noise=False, seed=seed)
    wd, _ = modal_consistency(det, labels, num_states)
    ham = adjacent_hamming(modal_codes(det, labels, num_states))
    sep = float(ham.mean()) if len(ham) else 0.0
    return float(w), sep, float(wd)


def _split_frames(store, splits, split: str):
    idx = [i for s in splits.of(split) for i in s]
    return idx, store.gather(np.asarray(idx))


def _variant(store, variant: str, latent_dim: int):
    """The model config for a store's frames."""
    return rbvae_variant(variant, latent_dim=latent_dim,
                         input_hw=tuple(store.item_shape[:2]),
                         in_channels=store.item_shape[2],
                         out_channels=store.item_shape[2])


def evaluate_sweep_dir(sweep_dir: str | Path, store, splits, flags,
                       variant: str = "contrastive",
                       temperature: float = 0.2, split: str = "val",
                       device=None) -> List[TradeoffPoint]:
    """Re-evaluate every ``best_model_<run>`` checkpoint in a sweep dir.

    Reads the per-run ``<run>_config.json`` (``{"config": {...}}``) for the
    latent dim and noise ratio; skips runs whose checkpoint is missing.
    """
    sweep_dir = Path(sweep_dir)
    idx, frames = _split_frames(store, splits, split)
    points = []
    for cfg_file in sorted(sweep_dir.glob("*_config.json")):
        run = cfg_file.name[:-len("_config.json")]
        ckpt = sweep_dir / f"best_model_{run}"
        if not ckpt.exists():
            continue
        config = json.loads(cfg_file.read_text()).get("config", {})
        bundle = RBVAEBundle.from_checkpoint(
            str(ckpt), _variant(store, variant, int(config["latent_dim"])),
            name=run, device=device)
        w, sep, wd = evaluate_checkpoint(
            bundle, frames, idx, flags, temperature=temperature,
            noise_ratio=float(config.get("noise_ratio", 0.1)))
        points.append(TradeoffPoint(run, w, sep, wd, config))
    return points


def evaluate_standalone(name: str, ckpt_dir: str | Path, store, splits,
                        flags, variant: str = "contrastive",
                        latent_dim: int = 25, noise_ratio: float = 0.1,
                        which: str = "best", temperature: float = 0.2,
                        split: str = "val", device=None) -> TradeoffPoint:
    """One trade-off point from a standalone trainer checkpoint dir
    (``Trainer.train(save_path=...)``), so hand-launched runs plot on the
    same chart as sweep trials."""
    idx, frames = _split_frames(store, splits, split)
    bundle = RBVAEBundle.from_checkpoint(
        str(ckpt_dir), _variant(store, variant, latent_dim), which=which,
        name=name, device=device)
    w, sep, wd = evaluate_checkpoint(bundle, frames, idx, flags,
                                     temperature=temperature,
                                     noise_ratio=noise_ratio)
    meta_file = Path(ckpt_dir) / f"{which}.json"
    config = (json.loads(meta_file.read_text())
              if meta_file.exists() else {})
    config["latent_dim"] = latent_dim
    return TradeoffPoint(name, w, sep, wd, config)


def write_csv(points: Sequence[TradeoffPoint], path: str | Path):
    keys = sorted({k for p in points for k in p.config})
    lines = ["run,consistency,det_consistency,separation_bits,"
             + ",".join(keys)]
    for p in points:
        cfg = ",".join(str(p.config.get(k, "")) for k in keys)
        lines.append(f"{p.run},{p.consistency:.6f},{p.det_consistency:.6f},"
                     f"{p.separation:.4f},{cfg}")
    Path(path).write_text("\n".join(lines) + "\n")


def pareto_front(points: Sequence[TradeoffPoint]) -> List[TradeoffPoint]:
    """Points not dominated in (consistency, separation)."""
    front = []
    for p in points:
        if not any(q.consistency >= p.consistency
                   and q.separation >= p.separation and q is not p
                   and (q.consistency > p.consistency
                        or q.separation > p.separation)
                   for q in points):
            front.append(p)
    return sorted(front, key=lambda p: p.separation)


def plot_tradeoff(points: Sequence[TradeoffPoint], path: str | Path,
                  sep_target: Optional[float] = 3.0,
                  title: str = "Consistency vs deterministic separation"):
    """Scatter of the points with their Pareto front (needs matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    xs = [p.separation for p in points]
    ys = [p.consistency for p in points]
    ax.scatter(xs, ys, s=36, zorder=3)
    for p in points:
        ax.annotate(p.run.replace("local_", "t"), (p.separation,
                    p.consistency), fontsize=7,
                    xytext=(3, 3), textcoords="offset points")
    front = pareto_front(points)
    if len(front) > 1:
        ax.plot([p.separation for p in front],
                [p.consistency for p in front],
                "--", lw=1, zorder=2, label="pareto front")
    if sep_target is not None:
        ax.axvline(sep_target, color="gray", lw=0.8, ls=":",
                   label=f"sep target {sep_target:g} bits")
    ax.set_xlabel("deterministic adjacent-state separation (bits)")
    ax.set_ylabel("weighted state consistency (eval protocol)")
    ax.set_ylim(0, 1.05)
    ax.set_title(title)
    ax.legend(loc="lower left", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
