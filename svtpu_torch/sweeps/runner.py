"""Sweep execution (``svtpu/sweeps/runner.py``): W&B Bayesian sweeps where
wandb imports and the caller wants them, a seeded local random search
otherwise.

Each trial builds the splits, the model and the port's ``Trainer`` on the
device given (the card unless ``"cpu"`` is asked for) from the sampled
config, trains, and saves its best model as ``best_model_<run>`` (the
port's ``best.pt`` / ``best.json``) beside ``<run>_config.json``, so that
``eval-tradeoff --sweep-dir`` reads the directory. A local sweep resumes:
a trial whose ``local_<t>_config.json`` records the config the seed
re-samples is not trained again.

Under a process group every rank trains each trial's one model (the
``Trainer``'s default mesh spans the world) on the same config: a local
sweep's ranks sample it from the same seed, which an all-gather of its
hash checks; a W&B sweep's agent and reports live on rank 0, which hands
each config to the other ranks. Rank 0 alone writes the sweep's files.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from svtpu_torch.config import TrainConfig, VideoMeta, rbvae_variant
from svtpu_torch.data.segments import split_segments
from svtpu_torch.parallel import distributed
from svtpu_torch.sweeps.spaces import METRIC, SPACES, sample, to_wandb_config
from svtpu_torch.training.trainer import Trainer


def train_with_config(config: Dict, variant: str, store,
                      video_meta: VideoMeta,
                      save_dir: Optional[str] = None,
                      run_name: str = "run",
                      compute_dtype: str = "bfloat16", device=None) -> Dict:
    """One sweep trial: config dict → trained model → metrics.

    Returns ``{"best_consistency_score", "best_val_loss",
    "best_combined_score", "best_separation", "history", "save_path"}``.
    """
    splits = split_segments(video_meta.state_segments())
    input_hw = tuple(store.item_shape[:2])
    in_ch = store.item_shape[2]
    # A space may be a variant of a model family ("contrastive_z" sweeps
    # the contrastive model with contrast_on="z").
    model_variant = {"contrastive_z": "contrastive",
                     "contrastive_p": "contrastive",
                     "percep_p": "percep"}.get(variant, variant)
    mkw = {}
    if "lstm_layers" in config:           # architecture factor (percep_p)
        mkw["lstm_layers"] = int(config["lstm_layers"])
    if "lstm_residual" in config:
        mkw["lstm_residual"] = bool(config["lstm_residual"])
    mcfg = rbvae_variant(model_variant, latent_dim=int(config["latent_dim"]),
                         input_hw=input_hw, in_channels=in_ch,
                         out_channels=in_ch, compute_dtype=compute_dtype,
                         **mkw)
    # num_steps_to_update = total steps / num_temp_updates
    # (``contrastive_RBVAE_wandb_sweep.py:92-97``): pairs per epoch =
    # ceil(longest state / 2), steps = ceil(pairs / batch).
    n_train_pairs = -(-max(len(s) for s in splits.train) // 2)
    steps_per_epoch = max(1, -(-n_train_pairs // int(config["batch_size"])))
    total_steps = int(config["num_epochs"]) * steps_per_epoch
    nstu = max(1, total_steps // int(config["num_temp_updates"]))

    tcfg = TrainConfig(
        batch_size=int(config["batch_size"]),
        num_epochs=int(config["num_epochs"]),
        learning_rate=float(config["learning_rate"]),
        init_temperature=float(config["init_temperature"]),
        final_temperature=float(config["final_temperature"]),
        anneal_rate=float(config["anneal_rate"]),
        num_steps_to_update=nstu,
        bernoulli_p=float(config["bernoulli_p"]),
        noise_ratio=float(config.get("noise_ratio", 0.1)),
        margin=float(config["margin"]),
        alpha=float(config["alpha"]),
        beta_kl=float(config["beta_kl"]),
        objective=str(config["objective"]),
        select_by=str(config["select_by"]),
        contrast_on=str(config.get("contrast_on", "h")),
        contextfree_contrast=bool(config.get("contextfree_contrast", False)),
        eval_noise_ratio=(None if config.get("eval_noise_ratio") is None
                          else float(config["eval_noise_ratio"])),
        sep_target=float(config.get("sep_target", 3.0)),
    )
    trainer = Trainer(mcfg, tcfg, store, splits, video_meta.flags,
                      device=device)
    save_path = (str(Path(save_dir) / f"best_model_{run_name}")
                 if save_dir else None)
    hist = trainer.train(num_epochs=tcfg.num_epochs, save_path=save_path)
    vals = hist["val_losses"]
    summary = {
        "best_consistency_score": float(max(
            (v.get("consistency_score", 0.0) for v in vals), default=0.0)),
        "best_val_loss": float(min(
            (v.get("total_loss", np.inf) for v in vals), default=np.inf)),
        "best_combined_score": float(max(
            (v.get("combined_score", 0.0) for v in vals), default=0.0)),
        "best_separation": float(max(
            (v.get("state_separation", 0.0) for v in vals), default=0.0))}
    if save_path:
        distributed.main_then_barrier(
            (Path(save_path).parent / f"{run_name}_config.json").write_text,
            json.dumps({"config": config, **summary}, indent=2))
    return {**summary, "history": hist, "save_path": save_path}


def _resumed_score(done: Optional[Path], cfg: Dict, metric: str,
                   label: str):
    """The score recorded for this trial, or None to train it: a record
    whose config differs from the re-sampled one (seed, space or count
    changed) would credit a config that never ran."""
    if done is None or not done.exists():
        return None
    prev = json.loads(done.read_text())
    score, prev_cfg = prev.get(metric), prev.get("config")
    if score is not None and prev_cfg is not None and prev_cfg != cfg:
        print(f"{label} recorded config differs from re-sampled config "
              f"(seed/space/count changed?) — retraining", flush=True)
        return None
    return score


def run_sweep(variant: str, store, video_meta: VideoMeta,
              count: int = 10, seed: int = 0,
              save_dir: Optional[str] = None,
              use_wandb: bool = True,
              epochs_override: Optional[int] = None, device=None) -> Dict:
    """Run ``count`` trials over the variant's space on ``device``.

    With wandb importable and ``use_wandb``: the Bayesian sweep and its
    agent (method and metric as the reference's). Otherwise: a seeded
    random search, whose result goes to ``sweep_results.json``.
    """
    space = dict(SPACES[variant])
    if epochs_override is not None:
        space["num_epochs"] = ("const", int(epochs_override))
    metric = METRIC[variant]

    if use_wandb and distributed.is_main():
        try:
            import wandb
        except ImportError:
            use_wandb = False
    if distributed.share(use_wandb):
        return _wandb_sweep(space, metric, variant, store, video_meta,
                            count, save_dir, device)

    rng = np.random.default_rng(seed)
    best, best_cfg, trials = None, None, []
    maximize = metric[1] == "maximize"
    for t in range(count):
        cfg = sample(space, rng)     # the rng always advances, so trial t's
        #                              config is seed-stable
        distributed.same_on_every_rank(cfg, f"trial {t}'s sampled config")
        label = f"[trial {t}/{count}]"
        done = Path(save_dir) / f"local_{t}_config.json" if save_dir else None
        distributed.barrier()        # every rank reads what rank 0 wrote
        score = _resumed_score(done, cfg, metric[0], label)
        if score is not None:
            print(f"{label} resumed: {metric[0]}={score:.4f}", flush=True)
            trials.append({"config": cfg, metric[0]: score})
            if best is None or (score > best if maximize else score < best):
                best, best_cfg = score, cfg
            continue
        brief = {k: (round(v, 5) if isinstance(v, float) else v)
                 for k, v in cfg.items()}
        print(f"{label} {brief}", flush=True)
        t0 = time.time()
        score = train_with_config(cfg, variant, store, video_meta, save_dir,
                                  run_name=f"local_{t}",
                                  device=device)[metric[0]]
        trials.append({"config": cfg, metric[0]: score})
        if best is None or (score > best if maximize else score < best):
            best, best_cfg = score, cfg
        print(f"{label} {metric[0]}={score:.4f} (best {best:.4f}) in "
              f"{time.time() - t0:.1f}s", flush=True)
    result = {"best": best, "best_config": best_cfg, "trials": trials,
              "metric": metric[0]}
    if save_dir:
        def write():
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            (Path(save_dir) / "sweep_results.json").write_text(
                json.dumps(result, indent=2, default=str))

        distributed.main_then_barrier(write)
    return result


def _wandb_sweep(space: Dict, metric, variant: str, store,
                 video_meta: VideoMeta, count: int,
                 save_dir: Optional[str], device) -> Dict:
    """The W&B Bayesian sweep and its agent (method and metric as the
    reference's) on rank 0, which reports; under a process group it hands
    each run's config and name to the other ranks, which train the same
    trial with it, and ``None`` when the agent is done."""
    if not distributed.is_main():
        while (job := distributed.share(None)) is not None:
            train_with_config(job[0], variant, store, video_meta, save_dir,
                              run_name=job[1], device=device)
        return {"sweep_id": distributed.share(None)}

    import wandb

    sweep_id = wandb.sweep(to_wandb_config(space, metric),
                           project=f"svtpu_{variant}_sweep")

    def agent_fn():
        run = wandb.init()
        config, name = distributed.share((dict(run.config),
                                          run.name or run.id))
        res = train_with_config(config, variant, store, video_meta, save_dir,
                                run_name=name, device=device)
        wandb.log({metric[0]: res[metric[0]]})
        if res["save_path"]:
            wandb.save(res["save_path"] + "*")
        run.finish()

    wandb.agent(sweep_id, function=agent_fn, count=count)
    distributed.share(None)
    return {"sweep_id": distributed.share(sweep_id)}
