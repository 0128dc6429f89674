"""State-consistency evaluation with perturbation robustness
(``svtpu/evaluation/consistency.py``): for each model, the weighted
fraction of *test* frames whose hard binary code equals their state's modal
code, under clean / gaussian-noise / occlusion inputs, over N trials.

The perturbations run on the bundle's device, on whole frame batches, with
their noise drawn from a generator seeded by the trial seed. A percep
model's perturbed pixels go back through the SD first stage by the
``pixel_to_input`` hook (``PerceptualEncoder.encode_frames``).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from svtpu_torch import resolve_device
from svtpu_torch.evaluation.common import RBVAEBundle, labels_of
from svtpu_torch.ops.image import (add_gaussian_noise, add_occlusion,
                                   occlude, random_corner)
from svtpu_torch.training.trainer import modal_consistency

PERTURBATIONS = ("clean", "noise", "occlusion")


def _perturb(x: np.ndarray, kind: str, seed: int, device, noise, occlusion):
    """Shared dispatch of both perturbation families: ``x`` unchanged for
    "clean", else ``noise(t, gen)`` or ``occlusion(t, gen)`` on ``x`` moved
    to ``device``, with ``gen`` seeded by ``seed`` there; back on the host."""
    if kind not in PERTURBATIONS:
        raise ValueError(kind)
    dev = resolve_device(device)
    if kind == "clean":
        return x
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    out = noise(t, gen) if kind == "noise" else occlusion(t, gen)
    return out.cpu().numpy()


def perturb_frames(frames01: np.ndarray, kind: str, seed: int,
                   noise_std: float = 0.1, occlusion_coverage: float = 0.2,
                   device=None) -> np.ndarray:
    """Apply one perturbation to ``[N, H, W, C]`` float [0,1] frames on
    ``device`` (CUDA unless "cpu" is asked for)."""
    return _perturb(
        frames01, kind, seed, device,
        lambda t, g: add_gaussian_noise(t, g, noise_std),
        lambda t, g: add_occlusion(t, g, occlusion_coverage))


def perturb_embeddings(emb: np.ndarray, kind: str, seed: int,
                       noise_std: float = 0.1,
                       occlusion_coverage: float = 0.2,
                       device=None) -> np.ndarray:
    """Embedding-space analogue of the pixel perturbations, for percep
    models without the SD checkpoint (the reference re-encodes perturbed
    pixels through SD, which needs it). Gaussian noise is scaled by the
    embedding std, so σ=0.1 keeps the reference's relative magnitude;
    occlusion zeroes a random ``side_h`` x ``side_w`` square of the latent
    grid, ~``coverage`` of it (one square per trial). ``emb``: ``[N, H, W,
    C]``."""
    def noise(t, gen):
        scale = noise_std * float(np.std(emb))
        return t + scale * torch.randn(t.shape, generator=gen,
                                       dtype=t.dtype, device=t.device)

    def occlusion(t, gen):
        H, W = t.shape[1:3]
        side_h, side_w = embedding_square(H, W, occlusion_coverage)
        top, left = random_corner(gen, H, W, side_h, side_w)
        return occlude(t, top, left, side_h, side_w, 0.0)

    return _perturb(emb, kind, seed, device, noise, occlusion)


def embedding_square(H: int, W: int, coverage: float):
    """The occlusion square of ``perturb_embeddings`` on an ``H`` x ``W``
    latent grid: ``(side_h, side_w)``, each at least 1."""
    return (max(1, int(H * coverage ** 0.5)),
            max(1, int(W * coverage ** 0.5)))


@dataclasses.dataclass
class ConsistencyResult:
    model_name: str
    perturbation: str
    mean: float
    std: float
    trials: List[float]


def evaluate_consistency(
        bundle: RBVAEBundle,
        test_frames01: np.ndarray,
        test_indices: Sequence[int],
        flags: Sequence[int],
        num_trials: int = 10,
        temperature: float = 0.2,
        noise_ratio: float = 0.1,
        perturbations: Sequence[str] = PERTURBATIONS,
        pixel_to_input: Optional[Callable[[np.ndarray, int], np.ndarray]]
        = None,
        perturb_fn: Optional[Callable[..., np.ndarray]] = None,
        seed: int = 0,
        labels: Optional[Sequence[int]] = None) -> List[ConsistencyResult]:
    """Run the trial protocol for one model.

    Trial ``t`` perturbs with seed ``s = seed + 1000 t`` and encodes with
    seed ``s + 1``.

    Args:
      test_frames01: ``[N, H, W, C]`` float [0,1] *pixel* frames (the
        perturbations are defined in pixel space even for the percep model).
      pixel_to_input: optional map from perturbed pixels to the model's
        input space (the SD encode step for percep models); receives
        ``(frames01, trial_seed)``.
      perturb_fn: ``(frames, kind, trial_seed) → frames``; by default
        ``perturb_frames`` on the bundle's device. Pass
        ``functools.partial(perturb_embeddings, device=...)`` for the
        embedding-space protocol.
      labels: optional explicit per-frame state labels (one global state
        axis across videos). When given, ``flags``/``test_indices`` are
        ignored for labeling.
    """
    labels, num_states = labels_of(test_indices, flags, labels)
    if perturb_fn is None:
        perturb_fn = functools.partial(perturb_frames, device=bundle.device)
    results = []
    for kind in perturbations:
        scores = []
        for trial in range(num_trials):
            s = seed + 1000 * trial
            frames = perturb_fn(test_frames01, kind, s)
            x = pixel_to_input(frames, s) if pixel_to_input else frames
            codes = bundle.encode(x, temperature=temperature, hard=True,
                                  noise=True, noise_ratio=noise_ratio,
                                  seed=s + 1)
            w, _ = modal_consistency(codes, labels, num_states)
            scores.append(w)
        results.append(ConsistencyResult(
            bundle.name, kind, float(np.mean(scores)),
            float(np.std(scores)), scores))
    return results


def write_csv(results: Sequence[ConsistencyResult], path: str | Path):
    """Mean/std CSV like the reference's."""
    lines = ["model,perturbation,mean,std"]
    for r in results:
        lines.append(f"{r.model_name},{r.perturbation},{r.mean:.6f},"
                     f"{r.std:.6f}")
    Path(path).write_text("\n".join(lines) + "\n")


def plot_results(results: Sequence[ConsistencyResult], path: str | Path,
                 title: str = "State consistency under perturbation"):
    """Grouped bar chart (needs matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = sorted({r.model_name for r in results})
    kinds = [k for k in PERTURBATIONS
             if any(r.perturbation == k for r in results)]
    x = np.arange(len(kinds))
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(8, 5))
    for mi, m in enumerate(models):
        means = [next(r.mean for r in results
                      if r.model_name == m and r.perturbation == k)
                 for k in kinds]
        stds = [next(r.std for r in results
                     if r.model_name == m and r.perturbation == k)
                for k in kinds]
        ax.bar(x + mi * width, means, width, yerr=stds, capsize=4, label=m)
    ax.set_xticks(x + width * (len(models) - 1) / 2)
    ax.set_xticklabels(kinds)
    ax.set_ylabel("weighted consistency")
    ax.set_ylim(0, 1.05)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
