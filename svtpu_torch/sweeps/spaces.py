"""Declarative hyperparameter spaces for the three reference sweeps
(``svtpu/sweeps/spaces.py``; the port keeps its own copy).

Each space is a dict ``name -> spec`` where spec is one of
  ("uniform", lo, hi) | ("log_uniform", lo, hi) |
  ("int_uniform", lo, hi) | ("choice", [values]) | ("const", value).
The same spec drives both the W&B sweep-config generator and the local
seeded sampler, so sweeps run identically with or without W&B.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np

Space = Dict[str, Tuple]

# ``models/contrastive_RBVAE/contrastive_RBVAE_wandb_sweep.py:166-243``:
# Bayes, maximize best_consistency_score.
CONTRASTIVE_SPACE: Space = {
    "learning_rate": ("log_uniform", 1e-5, 1e-2),
    "batch_size": ("choice", [16, 32, 64]),
    "latent_dim": ("choice", [25, 50, 75, 100]),
    "init_temperature": ("uniform", 1.0, 5.0),
    "final_temperature": ("uniform", 0.1, 0.5),
    "anneal_rate": ("log_uniform", 1e-5, 1e-2),
    "num_temp_updates": ("int_uniform", 550, 1100),
    "noise_ratio": ("uniform", 0.1, 0.2),
    "margin": ("uniform", 0.1, 1.0),
    "alpha": ("uniform", 0.5, 5.0),
    "beta_kl": ("uniform", 0.5, 5.0),
    "num_epochs": ("const", 100),
    "bernoulli_p": ("const", 0.1),
    "objective": ("const", "contrastive"),
    "select_by": ("const", "consistency"),
}

# ``models/percep_RBVAE/percep_RBVAE_wandb_sweep.py`` — same skeleton over
# embeddings, 750 epochs.
PERCEP_SPACE: Space = dict(CONTRASTIVE_SPACE, num_epochs=("const", 750))

# ``models/triplet_RBVAE/triplet_RBVAE_wandb_sweep.py:150-213`` — optimizes
# best_val_loss; bernoulli_p and alpha swept.
TRIPLET_SPACE: Space = {
    "learning_rate": ("log_uniform", 1e-5, 1e-2),
    "batch_size": ("choice", [16, 32, 64]),
    "latent_dim": ("choice", [25, 50, 75, 100]),
    "init_temperature": ("uniform", 1.0, 5.0),
    "final_temperature": ("uniform", 0.1, 0.5),
    "anneal_rate": ("log_uniform", 1e-5, 1e-2),
    "num_temp_updates": ("int_uniform", 550, 1100),
    "bernoulli_p": ("uniform", 0.3, 0.7),
    "margin": ("uniform", 0.1, 1.0),
    "alpha": ("uniform", 0.01, 1.0),
    "beta_kl": ("uniform", 0.5, 5.0),
    "num_epochs": ("const", 30),
    "objective": ("const", "triplet"),
    "select_by": ("const", "val_loss"),
}

# svtpu addition (no reference counterpart): sweep the ``contrast_on="z"``
# formulation and select by the combined consistency x separation score, so
# the search cannot converge to the all-states-one-code collapse the
# reference metric rewards (DESIGN.md §8). Ranges centered on the round-1
# hand-tuned point (margin 2, alpha 4, beta_kl 0.2 → 3.5-bit separation).
CONTRASTIVE_Z_SPACE: Space = dict(
    CONTRASTIVE_SPACE,
    margin=("uniform", 0.5, 4.0),
    alpha=("uniform", 1.0, 8.0),
    beta_kl=("log_uniform", 0.02, 1.0),
    contrast_on=("const", "z"),
    select_by=("const", "combined"),
)

# Same search, margin on the unit-temperature probabilities instead
# (``contrast_on="p"`` — keeps the contrastive gradient alive after the
# anneal; DESIGN.md §8). Margin bounds stay valid: p-space euclidean
# distance is bounded by sqrt(latent_dim) ≥ 5 for every swept latent.
CONTRASTIVE_P_SPACE: Space = dict(
    CONTRASTIVE_Z_SPACE,
    contrast_on=("const", "p"),
)

# svtpu addition: the flagship objective searched on the PERCEP model
# geometry (convs 256³ over SD latents, 4-layer LSTMs) — the search the
# round-2 "honest negative" left unrun. Widened low end for beta_kl (KL
# pressure is a collapse suspect at this trunk's logit statistics) and
# noise_ratio (percep logits start much smaller than pixel logits, so the
# pixel-tuned 0.3 noise can drown them); context-free term and decoupled
# eval noise are part of the searched mechanism set.
PERCEP_P_SPACE: Space = dict(
    CONTRASTIVE_P_SPACE,
    latent_dim=("choice", [25, 50]),
    # Architecture factor: the round-3 collapse diagnosis localized the
    # percep failure to LSTM depth (4-layer -> logits stuck near 0 at
    # the flagship lr; 2-layer separates 24/25 bits in 200 epochs), so
    # the search covers both depths (reference fixes 4:
    # ``percep_RBVAE_model.py:98,111``).
    lstm_layers=("choice", [2, 4]),
    # Second architecture factor (round 3): residual stacking fixed the
    # 4-layer starvation outright (best combined 1.0, no late erosion —
    # RESULTS.md "Percep collapse"), so the search covers it.
    lstm_residual=("choice", [False, True]),
    batch_size=("choice", [16, 32]),
    learning_rate=("log_uniform", 1e-4, 3e-3),
    beta_kl=("log_uniform", 0.005, 0.5),
    noise_ratio=("uniform", 0.05, 0.3),
    margin=("uniform", 1.0, 4.0),
    alpha=("uniform", 2.0, 8.0),
    contextfree_contrast=("const", True),
    eval_noise_ratio=("const", 0.1),
    num_epochs=("const", 300),
)

SPACES = {"contrastive": CONTRASTIVE_SPACE, "percep": PERCEP_SPACE,
          "triplet": TRIPLET_SPACE, "contrastive_z": CONTRASTIVE_Z_SPACE,
          "contrastive_p": CONTRASTIVE_P_SPACE,
          "percep_p": PERCEP_P_SPACE}

METRIC = {"contrastive": ("best_consistency_score", "maximize"),
          "percep": ("best_consistency_score", "maximize"),
          "triplet": ("best_val_loss", "minimize"),
          "contrastive_z": ("best_combined_score", "maximize"),
          "contrastive_p": ("best_combined_score", "maximize"),
          "percep_p": ("best_combined_score", "maximize")}


def sample(space: Space, rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "uniform":
            out[name] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "log_uniform":
            out[name] = float(math.exp(
                rng.uniform(math.log(spec[1]), math.log(spec[2]))))
        elif kind == "int_uniform":
            out[name] = int(rng.integers(spec[1], spec[2] + 1))
        elif kind == "choice":
            out[name] = spec[1][int(rng.integers(len(spec[1])))]
        elif kind == "const":
            out[name] = spec[1]
        else:
            raise ValueError(kind)
    return out


def to_wandb_config(space: Space, metric: Tuple[str, str],
                    method: str = "bayes") -> Dict:
    """Translate a space into a W&B sweep config dict."""
    params = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "uniform":
            params[name] = {"distribution": "uniform",
                            "min": spec[1], "max": spec[2]}
        elif kind == "log_uniform":
            params[name] = {"distribution": "log_uniform_values",
                            "min": spec[1], "max": spec[2]}
        elif kind == "int_uniform":
            params[name] = {"distribution": "int_uniform",
                            "min": spec[1], "max": spec[2]}
        elif kind == "choice":
            params[name] = {"values": list(spec[1])}
        elif kind == "const":
            params[name] = {"value": spec[1]}
    return {"method": method,
            "metric": {"name": metric[0], "goal": metric[1]},
            "parameters": params}
