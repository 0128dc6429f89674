"""Command line of the port: ``python -m svtpu_torch.cli <command>``, the
counterpart of ``python -m svtpu.cli`` (``svtpu/cli.py``), with the same
commands, flags, defaults and train presets.

  extract          video → frame dir (cv2, native, pyav or decord backend)
  convert          video container / codec conversion (OpenCV's writer)
  encode           video file or frame dir + trained ckpt → packed symbols npz
  train            train an RBVAE variant (``--preset`` for a measured recipe;
                   ``--multi`` for several videos on one state axis)
  sweep            hyperparameter sweep (W&B, or a seeded local random
                   search that resumes)
  embed            frames → perceptual embeddings .npy (SD first stage)
  interpolate      SD latent interpolation demo
  eval-consistency / eval-hamming / eval-projections / eval-probe /
  eval-tradeoff    the evaluations, one model or several side by side

Every command that builds a model takes ``--device``: without it the
command runs on the CUDA card, and without a card it exits with the card
error; it never falls back to the CPU. Checkpoint directories are the
port's (``Trainer.train(save_path=...)``'s ``best.pt`` and ``best.json``).

The one deliberate difference from ``svtpu``: each eval command writes its
CSV and prints its results first, then draws its chart where matplotlib
imports; where it does not, it prints one line saying the chart was not
written (``eval-projections`` then writes each projection's points as a
CSV). ``eval-projections`` and ``eval-probe`` need sklearn for the fit
itself. matplotlib, sklearn and PIL are imported only where they are used.

Several cards: ``python3 -m torch.distributed.run --standalone
--nproc-per-node N -m svtpu_torch.cli <command> ...`` starts one process a
card, as ``svtpu`` spans every chip of its host with no flag. ``train``,
``sweep``, ``embed``, ``interpolate`` and ``eval-consistency --sd-ckpt``
(whose ``svtpu`` counterparts build a mesh) run on every rank, data
parallel, and rank 0 alone writes their files and prints; every other
command runs on rank 0 alone, with no process group, and the other ranks
return at once. Without a launcher a command is one process on one card.

``SVTPU_DETERMINISTIC=1`` in the environment makes a command use PyTorch's
deterministic algorithms, so that two runs of it give the same bits.
``SVTPU_LAUNCHES_DIR=D`` makes each rank write its hand kernels' launches
and its train step graphs' captures and replays in the command to
``D/launches_<rank>.json``.

Run: ``python -m svtpu_torch.cli <command> --help``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

from svtpu_torch import NoCardError, resolve_device
from svtpu_torch.parallel import distributed


def _meta_by_name(args, name):
    from svtpu_torch.config import (BUILTIN_VIDEOS, VideoMeta,
                                    parse_transition_flags)

    if args.flags_file:
        metas = parse_transition_flags(args.flags_file)
        if name in metas:
            return metas[name]
    if name in BUILTIN_VIDEOS:
        return BUILTIN_VIDEOS[name]
    if args.flags and name == args.video:
        return VideoMeta(name, tuple(args.flags), args.last_frame,
                         args.grey_out)
    raise SystemExit(f"unknown video {name!r}; pass --flags/"
                     f"--last-frame or --flags-file")


def _video_meta(args):
    if not args.video:
        raise SystemExit("--video is required")
    return _meta_by_name(args, args.video)


def _add_video_args(p, required=True):
    p.add_argument("--video", required=required,
                   help="video name (builtin or from --flags-file)")
    p.add_argument("--flags-file", help="transition_flags.txt path")
    p.add_argument("--flags", type=int, nargs="*",
                   help="transition frame indices")
    p.add_argument("--last-frame", type=int)
    p.add_argument("--grey-out", type=int, default=10)


def _add_device_arg(p):
    p.add_argument("--device",
                   help="torch device: cuda (the default) or cpu; without a "
                        "card the command exits unless given --device cpu")


def _multi_setup(args):
    """Several videos on one global state axis (``svtpu/cli.py:61-77``).
    Each ``--multi`` spec is NAME=FRAMES_DIR; NAME resolves like
    ``--video``. Returns ``(MultiStore, SplitIndices, labels)``."""
    from svtpu_torch.data.datasets import FrameStore
    from svtpu_torch.data.multi import combine_videos

    specs = []
    for spec in args.multi:
        if "=" not in spec:
            raise SystemExit(f"--multi needs NAME=FRAMES_DIR: {spec!r}")
        name, frames_dir = spec.split("=", 1)
        m = _meta_by_name(args, name)
        fs = FrameStore(frames_dir, list(range(m.last_frame + 1)),
                        resolution=(args.resolution, args.resolution))
        specs.append((fs, m))
    return combine_videos(specs, args.test_pct, args.val_pct)


def _pixel_store(args, meta):
    from svtpu_torch.data.datasets import FrameStore
    from svtpu_torch.data.segments import split_segments

    splits = split_segments(meta.state_segments(), args.test_pct,
                            args.val_pct)
    all_idx = (list(splits.flat("train")) + list(splits.flat("val"))
               + list(splits.flat("test")))
    store = FrameStore(args.frames_dir, all_idx,
                       resolution=(args.resolution, args.resolution))
    return store, splits


def cmd_encode(args):
    """The product operation: video file or frame dir + trained ckpt →
    packed binary symbol codes (SymbolStore npz). Reference protocol
    defaults: temp 0.2, hard=True, Binary-Concrete noise on
    (``embedding_matching.py:264``). A frame directory's batch ``i`` (its
    first frame's index) draws its noise from ``batch_seed(seed, i)``, as
    ``svtpu`` folds ``i`` into its key; a video file goes through
    ``run_video``, whose batch ``b`` (its ordinal) draws from
    ``batch_seed(seed, b)``."""
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.data.datasets import FrameStore
    from svtpu_torch.data.symbols import SymbolStore
    from svtpu_torch.pipeline import VideoSymbolPipeline
    from svtpu_torch.training.checkpoints import BestCheckpointer

    src = Path(args.input)
    cfg = rbvae_variant(args.variant, latent_dim=args.latent_dim,
                        input_hw=(args.resolution, args.resolution),
                        compute_dtype=args.dtype, **_model_overrides(args))
    tree, _ = BestCheckpointer(args.ckpt).restore(args.which)
    pipe = VideoSymbolPipeline(cfg, tree["model"], batch=args.batch,
                               temperature=args.temperature, hard=True,
                               noise=not args.deterministic,
                               noise_ratio=args.noise_ratio, seed=args.seed,
                               resize_on=args.resize_on, device=args.device)
    if src.is_dir():
        n = len([f for f in src.iterdir() if f.suffix == ".jpg"])
        if args.limit:
            n = min(n, args.limit)
        store = FrameStore(str(src), list(range(n)),
                           resolution=cfg.input_hw)
        chunks = [pipe.run_frames(
            store.gather(np.arange(i, min(i + args.batch, n))),
            batch_index=i) for i in range(0, n, args.batch)]
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros((0, cfg.latent_dim)))
    else:
        codes = pipe.run_video(str(src), limit=args.limit)
    labels = None
    if args.video:
        from svtpu_torch.data.segments import assign_label

        meta = _video_meta(args)
        labels = np.asarray([assign_label(i, meta.flags)
                             for i in range(len(codes))])
    SymbolStore(codes, np.arange(len(codes)), labels).save(args.out)
    print(f"wrote {len(codes)} symbol codes (dim {codes.shape[-1]}) "
          f"to {args.out}")


def cmd_extract(args):
    from svtpu_torch.data.frames import extract_frames

    n = extract_frames(args.video_path, args.out_dir, backend=args.backend,
                       every_n=args.every_n, limit=args.limit)
    print(f"wrote {n} frames to {args.out_dir}")


def cmd_convert(args):
    from svtpu_torch.data.frames import convert_video

    convert_video(args.src, args.dst, fourcc=args.fourcc)
    print(f"converted {args.src} -> {args.dst}")


def cmd_download_weights(args):
    from svtpu_torch.data.frames import download_sd_weights

    path = download_sd_weights(args.out_dir)
    print(path)


def cmd_embed(args):
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.perceptual.convert import (load_sd_first_stage,
                                                load_torch_checkpoint)
    from svtpu_torch.perceptual.embed import precompute_embeddings

    cfg = PerceptualConfig()
    params = load_sd_first_stage(load_torch_checkpoint(args.ckpt))
    emb = precompute_embeddings(
        args.frames_dir, args.out, params, cfg,
        batch_size=args.batch_size,
        stochastic=not args.deterministic, seed=args.seed,
        device=args.device)
    print(f"saved {len(emb)} embeddings to {args.out}")


# Measured training recipes as one flag, value for value svtpu's
# (svtpu/cli.py:185-240, whose comments trace each to RESULTS.md);
# explicit flags still override a preset's defaults.
TRAIN_PRESETS = {
    # The flagship pixels objective, "preset v2": L1 logit brake 0.1 +
    # strict restart min_sep 10, full anneal to 0.2.
    "flagship": dict(
        variant="contrastive", latent_dim=25, epochs=1000, batch_size=32,
        lr=3e-4, init_temp=2.0, final_temp=0.2, anneal_rate=1e-3,
        num_steps_to_update=4, bernoulli_p=0.1, contrast_on="p",
        contextfree_contrast=True, margin=3.5, noise_ratio=0.3,
        eval_noise_ratio=0.1, beta_kl=0.2, alpha=4.0, select_by="combined",
        l1_logits=0.1,
        restart_check_epoch=250, restart_min_sep=10.0, max_restarts=3),
    # The superseded round-3 default (anneal floor 0.55 + lax restart).
    "flagship-v1": dict(
        variant="contrastive", latent_dim=25, epochs=1000, batch_size=32,
        lr=3e-4, init_temp=2.0, final_temp=0.55, anneal_rate=1e-3,
        num_steps_to_update=4, bernoulli_p=0.1, contrast_on="p",
        contextfree_contrast=True, margin=3.5, noise_ratio=0.3,
        eval_noise_ratio=0.1, beta_kl=0.2, alpha=4.0, select_by="combined",
        restart_check_epoch=250, restart_min_sep=3.0, max_restarts=3),
    # The percep (SD-latent) recipe: the reference's 4-layer geometry with
    # residual LSTM stacks against its depth-starvation collapse.
    "percep-flagship": dict(
        variant="percep", latent_dim=25, epochs=750, batch_size=16,
        lr=3e-4, init_temp=2.0, final_temp=0.2, anneal_rate=3e-4,
        num_steps_to_update=4, bernoulli_p=0.1, contrast_on="p",
        contextfree_contrast=True, margin=3.5, noise_ratio=0.3,
        eval_noise_ratio=0.1, beta_kl=0.2, alpha=4.0, select_by="combined",
        lstm_residual=True),
    # The multi-video recipe, with repeatable --multi NAME=FRAMES_DIR: a
    # higher anneal floor and min-aggregated separation, so selection
    # cannot reward a run that merged one video's states. svtpu's caveat
    # holds: its result did not replicate across seeds.
    "multi-video": dict(
        variant="contrastive", latent_dim=25, epochs=1500, batch_size=32,
        lr=3e-4, init_temp=2.0, final_temp=0.95, anneal_rate=3e-4,
        num_steps_to_update=4, bernoulli_p=0.1, contrast_on="p",
        contextfree_contrast=True, margin=3.5, noise_ratio=0.3,
        eval_noise_ratio=0.1, beta_kl=0.05, alpha=4.0,
        select_by="combined", sep_aggregate="min"),
}


def cmd_train(args):
    from svtpu_torch.config import TrainConfig, rbvae_variant
    from svtpu_torch.data.datasets import EmbeddingStore
    from svtpu_torch.data.segments import split_segments
    from svtpu_torch.training.trainer import Trainer

    labels = None
    if getattr(args, "multi", None):
        if args.variant != "contrastive":
            raise SystemExit("--multi supports the contrastive variant")
        store, splits, labels = _multi_setup(args)
        meta = None
    elif args.variant == "percep":
        meta = _video_meta(args)
        store = EmbeddingStore(args.embeddings)
        splits = split_segments(meta.state_segments(), args.test_pct,
                                args.val_pct)
    else:
        meta = _video_meta(args)
        store, splits = _pixel_store(args, meta)

    input_hw = tuple(store.item_shape[:2])
    in_ch = store.item_shape[2]
    mcfg = rbvae_variant(args.variant, latent_dim=args.latent_dim,
                         input_hw=input_hw, in_channels=in_ch,
                         out_channels=in_ch, compute_dtype=args.dtype,
                         **_model_overrides(args))
    tcfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.lr, init_temperature=args.init_temp,
        final_temperature=args.final_temp, anneal_rate=args.anneal_rate,
        num_steps_to_update=args.num_steps_to_update,
        bernoulli_p=args.bernoulli_p, noise_ratio=args.noise_ratio,
        eval_noise_ratio=args.eval_noise_ratio,
        margin=args.margin, alpha=args.alpha, beta_kl=args.beta_kl,
        contrast_on=args.contrast_on,
        triplet_distance=args.triplet_distance,
        triplet_pull=args.triplet_pull,
        triplet_push=args.triplet_push,
        contextfree_contrast=args.contextfree_contrast,
        objective=("triplet" if args.variant == "triplet" else
                   "simple" if args.variant == "simple" else "contrastive"),
        select_by=(args.select_by or
                   ("val_loss" if args.variant == "triplet"
                    else "consistency")),
        sep_target=args.sep_target,
        sep_aggregate=args.sep_aggregate,
        restart_check_epoch=args.restart_check_epoch,
        restart_min_sep=args.restart_min_sep,
        max_restarts=args.max_restarts,
        restart_on=args.restart_on,
        restart_reroll=args.restart_reroll,
        trap_guard_ratio=args.trap_guard_ratio,
        l1_logits=args.l1_logits,
        val_every=args.val_every,
        fused_epoch=not args.no_fused_epoch,
        log_dir=args.log_dir, seed=args.seed)
    trainer = Trainer(mcfg, tcfg, store, splits,
                      meta.flags if meta is not None else [],
                      labels_by_index=labels, device=args.device)
    if args.variant == "simple":
        hist = trainer.train_simple(meta.state_segments(),
                                    num_epochs=args.epochs)
        # Loss trajectory (the reference's simple loop only prints per-epoch
        # losses, ``simple_RBVAE_train.py:181-186``): first/last + deciles.
        n = len(hist["train_losses"])
        for e in sorted({0, n - 1, *range(0, n, max(1, n // 10))}):
            print(json.dumps({"epoch": e, **hist["train_losses"][e]}))
        if args.save_path:
            from svtpu_torch.training.checkpoints import save_params_npz
            distributed.main_then_barrier(
                save_params_npz, hist["final_state"].model.state_dict(), mcfg,
                str(args.save_path) + "_params.npz")
            print(f"saved params to {args.save_path}_params.npz")
        return
    hist = trainer.train(num_epochs=args.epochs, save_path=args.save_path,
                         resume=args.resume)
    print(f"best {tcfg.select_by}: {hist['best_metric']:.4f} "
          f"at epoch {hist['best_epoch']}")
    if "trap_guard" in hist:
        print(json.dumps({"trap_guard": hist["trap_guard"]}))
    if args.history_out and distributed.is_main():
        # Full per-epoch metric trajectories (JSONL: one epoch per line,
        # train + val merged), then a meta row without an "epoch" key.
        p = Path(args.history_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            for e, (t, v) in enumerate(zip(hist["train_losses"],
                                           hist["val_losses"])):
                f.write(json.dumps({"epoch": e,
                                    **{k: round(float(x), 6)
                                       for k, x in t.items()},
                                    **{k: round(float(x), 6)
                                       for k, x in v.items()}}) + "\n")
            meta = {"best_epoch": hist["best_epoch"],
                    "best_metric": float(hist["best_metric"]),
                    "wall_time_s": round(hist.get("wall_time_s", 0.0), 1)}
            if hist.get("restarts"):
                meta["restarts"] = hist["restarts"]
            f.write(json.dumps({"meta": meta}) + "\n")
        print(f"history -> {p}")


def cmd_sweep(args):
    from svtpu_torch.data.datasets import EmbeddingStore
    from svtpu_torch.sweeps.runner import run_sweep

    meta = _video_meta(args)
    if args.variant.startswith("percep"):
        store = EmbeddingStore(args.embeddings)
    else:
        store, _ = _pixel_store(args, meta)
    res = run_sweep(args.variant, store, meta, count=args.count,
                    seed=args.seed, save_dir=args.save_dir,
                    use_wandb=not args.no_wandb,
                    epochs_override=args.epochs, device=args.device)
    if "best" in res:
        print(f"best {res['metric']}: {res['best']}")


def _model_overrides(args):
    kw = {"lstm_residual": getattr(args, "lstm_residual", False)}
    if getattr(args, "lstm_layers", None):
        kw["lstm_layers"] = args.lstm_layers
    return kw


def _bundle(args, store):
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.evaluation.common import RBVAEBundle

    input_hw = tuple(store.item_shape[:2])
    in_ch = store.item_shape[2]
    cfg = rbvae_variant(args.variant, latent_dim=args.latent_dim,
                        input_hw=input_hw, in_channels=in_ch,
                        out_channels=in_ch, **_model_overrides(args))
    return RBVAEBundle.from_checkpoint(args.ckpt, cfg, name=args.variant,
                                       device=args.device)


def _eval_store(args, meta):
    """FrameStore for pixel models, EmbeddingStore when --embeddings is
    given (percep models evaluate in embedding space for hamming/
    projections/probe, matching the reference's precomputed-embedding
    path)."""
    from svtpu_torch.data.segments import split_segments

    if getattr(args, "embeddings", None):
        from svtpu_torch.data.datasets import EmbeddingStore

        splits = split_segments(meta.state_segments(), args.test_pct,
                                args.val_pct)
        return EmbeddingStore(args.embeddings), splits
    return _pixel_store(args, meta)


def _model_namespaces(args):
    """Expand repeatable ``--model key=value,...`` specs into per-model
    argument namespaces (the reference's hard-coded two-model comparison,
    ``embedding_matching.py:366-397``). Without ``--model``, the single
    ``--ckpt``/``--variant`` pair is one spec."""
    if not getattr(args, "model", None):
        if not args.ckpt:
            raise SystemExit("provide --ckpt or at least one --model")
        return [(args.variant, args)]
    out = []
    for spec in args.model:
        kv = {}
        for part in spec.split(","):
            if "=" not in part:
                raise SystemExit(f"bad --model entry {part!r}; expected "
                                 "key=value[,key=value...]")
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
        unknown = set(kv) - {"variant", "ckpt", "latent", "name",
                             "embeddings"}
        if unknown:
            raise SystemExit(f"unknown --model keys: {sorted(unknown)}")
        if "ckpt" not in kv:
            raise SystemExit(f"--model needs ckpt=...: {spec!r}")
        ns = argparse.Namespace(**vars(args))
        ns.ckpt = kv["ckpt"]
        ns.variant = kv.get("variant", args.variant)
        ns.latent_dim = int(kv.get("latent", args.latent_dim))
        if "embeddings" in kv:
            ns.embeddings = kv["embeddings"]
        out.append((kv.get("name", ns.variant), ns))
    if len({n for n, _ in out}) != len(out):
        raise SystemExit("duplicate --model names; add name=... to "
                         "disambiguate")
    return out


def _consistency_for_model(name, args, meta):
    import functools

    from svtpu_torch.data.datasets import FrameStore
    from svtpu_torch.data.segments import split_segments
    from svtpu_torch.evaluation.consistency import evaluate_consistency

    if getattr(args, "multi", None):
        # A multi-video checkpoint: global state labels from
        # combine_videos.
        store, splits, labels_map = _multi_setup(args)
        test_idx = splits.flat("test")
        frames01 = store.gather(np.asarray(test_idx)).astype(np.float32)
        frames01 /= 255.0
        bundle = _bundle(args, store)
        bundle.name = name
        return evaluate_consistency(
            bundle, frames01, test_idx, [], num_trials=args.trials,
            temperature=args.temperature,
            labels=[labels_map[i] for i in test_idx])

    pixel_to_input = None
    perturb_fn = None
    embedding_input = False
    if args.variant == "percep" and getattr(args, "embeddings", None) \
            and not getattr(args, "sd_ckpt", None):
        # The embedding-space protocol, for want of an SD checkpoint: the
        # perturbations act on the latents (PARITY.md); clean-column
        # numbers are protocol-identical.
        from svtpu_torch.data.datasets import EmbeddingStore
        from svtpu_torch.evaluation.consistency import perturb_embeddings

        store = EmbeddingStore(args.embeddings)
        splits = split_segments(meta.state_segments(), args.test_pct,
                                args.val_pct)
        perturb_fn = functools.partial(perturb_embeddings,
                                       device=args.device)
        embedding_input = True
    elif args.variant == "percep":
        # Percep models: perturb pixels at SD resolution, re-encode through
        # the AutoencoderKL per trial (reference
        # ``embedding_matching.py:251-257``).
        if not getattr(args, "sd_ckpt", None):
            raise SystemExit("--sd-ckpt (or --embeddings for the "
                             "embedding-space degraded protocol) is "
                             "required for --variant percep")
        from svtpu_torch.config import PerceptualConfig
        from svtpu_torch.perceptual.convert import (load_sd_first_stage,
                                                    load_torch_checkpoint)
        from svtpu_torch.perceptual.embed import (PerceptualEncoder,
                                                  preprocess_size)

        pcfg = PerceptualConfig()
        enc = PerceptualEncoder(
            load_sd_first_stage(load_torch_checkpoint(args.sd_ckpt)), pcfg,
            device=args.device)
        w, h = preprocess_size(pcfg.resize_wh)
        splits = split_segments(meta.state_segments(), args.test_pct,
                                args.val_pct)
        store = FrameStore(args.frames_dir, splits.flat("test"),
                           resolution=(h, w))

        def pixel_to_input(frames01, seed):
            enc.seed = seed
            return enc.encode_frames(
                np.clip(frames01 * 255.0, 0, 255).astype(np.uint8))
    else:
        store, splits = _pixel_store(args, meta)
    test_idx = splits.flat("test")
    frames01 = store.gather(np.asarray(test_idx)).astype(np.float32)
    if not embedding_input:
        frames01 = frames01 / 255.0
    if args.variant != "percep":
        bundle = _bundle(args, store)
    else:
        from svtpu_torch.config import rbvae_variant
        from svtpu_torch.evaluation.common import RBVAEBundle

        cfg = rbvae_variant("percep", latent_dim=args.latent_dim,
                            **_model_overrides(args))
        bundle = RBVAEBundle.from_checkpoint(args.ckpt, cfg, name="percep",
                                             device=args.device)
    bundle.name = name
    kw = {}
    if perturb_fn is not None:
        kw["perturb_fn"] = perturb_fn
    return evaluate_consistency(bundle, frames01, test_idx, meta.flags,
                                num_trials=args.trials,
                                temperature=args.temperature,
                                pixel_to_input=pixel_to_input, **kw)


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _no_chart(path) -> None:
    print(f"chart not written (matplotlib is not installed): {path}")


def _chart(path, draw) -> None:
    """``draw(path)`` where matplotlib imports; else one line saying the
    chart was not written (the CSV and stdout hold the results)."""
    if _has_matplotlib():
        draw(path)
    else:
        _no_chart(path)


def cmd_eval_consistency(args):
    """One or many models side by side in one chart/CSV (the reference
    compares its pixels and perceps best models in a single artifact,
    ``embedding_matching.py:400-565``)."""
    from svtpu_torch.evaluation.consistency import plot_results, write_csv

    meta = None if getattr(args, "multi", None) else _video_meta(args)
    results = []
    for name, ns in _model_namespaces(args):
        results.extend(_consistency_for_model(name, ns, meta))
    if not distributed.is_main():     # --sd-ckpt under a launcher
        return
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_csv(results, out / "consistency.csv")
    for r in results:
        print(f"{r.model_name} {r.perturbation}: {r.mean:.4f} ± {r.std:.4f}")
    _chart(out / "consistency.png", lambda p: plot_results(results, p))


def cmd_eval_hamming(args):
    """One or many models in one chart/CSV (reference:
    ``embedding_hamming_distance.py:193-288``; per-model ``embeddings=...``
    routes a percep model to its precomputed-embedding store while pixel
    models read frames)."""
    from svtpu_torch.evaluation.hamming import (evaluate_hamming,
                                                plot_results, write_csv)

    multi = getattr(args, "multi", None)
    meta = None if multi else _video_meta(args)
    results = {}
    for name, ns in _model_namespaces(args):
        if multi:
            store, splits, labels_map = _multi_setup(ns)
        else:
            store, splits = _eval_store(ns, meta)
        test_idx = splits.flat("test")
        labels = [labels_map[i] for i in test_idx] if multi else None
        frames = store.gather(np.asarray(test_idx))
        bundle = _bundle(ns, store)
        results[name] = evaluate_hamming(bundle, frames, test_idx,
                                         meta.flags if meta else [],
                                         temperature=ns.temperature,
                                         labels=labels)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_csv(results, out / "hamming.csv")
    for name, res in results.items():
        print(f"{name} adjacent hamming:", res["hamming"].tolist())
    _chart(out / "hamming.png", lambda p: plot_results(results, p))


def cmd_eval_projections(args):
    """UMAP / t-SNE / PCA charts of each model's soft codes; without
    matplotlib, each projection's points as ``<name>_<method>.csv``
    (x, y, state)."""
    from svtpu_torch.evaluation.common import labels_of
    from svtpu_torch.evaluation.projections import (evaluate_projections,
                                                    project, soft_codes)

    meta = _video_meta(args)
    specs = _model_namespaces(args)
    charts = _has_matplotlib()
    written = {}
    for name, ns in specs:
        store, splits = _eval_store(ns, meta)
        test_idx = splits.flat("test")
        frames = store.gather(np.asarray(test_idx))
        bundle = _bundle(ns, store)
        out = (Path(args.out_dir) / name if len(specs) > 1
               else Path(args.out_dir))
        if charts:
            written[name] = evaluate_projections(bundle, frames, test_idx,
                                                 meta.flags, out)
            continue
        out.mkdir(parents=True, exist_ok=True)
        labels, _ = labels_of(test_idx, meta.flags)
        codes = soft_codes(bundle, frames)
        written[name] = {}
        for m in ("pca", "tsne", "umap"):
            p = out / f"{bundle.name}_{m}.csv"
            np.savetxt(p, np.column_stack([project(codes, m), labels]),
                       fmt="%.6g", delimiter=",", header="x,y,state",
                       comments="")
            written[name][m] = str(p)
    print(json.dumps(written if len(specs) > 1
                     else next(iter(written.values()))))
    if not charts:
        for paths in written.values():
            for p in paths.values():
                _no_chart(Path(p).with_suffix(".png"))


def cmd_eval_probe(args):
    from svtpu_torch.evaluation.linear_probe import evaluate_linear_probe

    meta = _video_meta(args)
    specs = _model_namespaces(args)
    charts = _has_matplotlib()
    metrics, examples = {}, []
    for name, ns in specs:
        store, splits = _eval_store(ns, meta)
        test_idx = splits.flat("test")
        frames = store.gather(np.asarray(test_idx))
        bundle = _bundle(ns, store)
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        examples.append(out / (f"probe_example_{name}.png" if len(specs) > 1
                               else "probe_example.png"))
        metrics[name] = evaluate_linear_probe(
            bundle, frames, example_path=examples[-1] if charts else None)
    print(json.dumps(metrics if len(specs) > 1
                     else next(iter(metrics.values()))))
    if not charts:
        for p in examples:
            _no_chart(p)


def cmd_eval_tradeoff(args):
    """Joint (consistency, separation) table/chart over every checkpoint a
    sweep saved (``svtpu``'s addition; DESIGN.md §8)."""
    from svtpu_torch.evaluation.tradeoff import (evaluate_standalone,
                                                 evaluate_sweep_dir,
                                                 pareto_front, plot_tradeoff,
                                                 write_csv)

    meta = _video_meta(args)
    store, splits = _eval_store(args, meta)
    points = []
    if args.sweep_dir:
        points += evaluate_sweep_dir(args.sweep_dir, store, splits,
                                     meta.flags, variant=args.variant,
                                     temperature=args.temperature,
                                     split=args.split, device=args.device)
    for spec in args.extra or []:
        # NAME:CKPT_DIR:LATENT[:WHICH] — a standalone trainer checkpoint.
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise SystemExit(f"--extra wants NAME:DIR:LATENT[:WHICH], "
                             f"got {spec!r}")
        name, ckpt_dir, latent = parts[:3]
        which = parts[3] if len(parts) == 4 else "best"
        points.append(evaluate_standalone(
            name, ckpt_dir, store, splits, meta.flags,
            variant=args.variant, latent_dim=int(latent), which=which,
            temperature=args.temperature, split=args.split,
            device=args.device))
    if not points:
        raise SystemExit("no evaluated checkpoints "
                         "(give --sweep-dir and/or --extra)")
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_csv(points, out / "tradeoff.csv")
    for p in sorted(points, key=lambda p: -p.consistency
                    * min(p.separation / args.sep_target, 1.0)):
        print(f"{p.run}: consistency {p.consistency:.3f} "
              f"(det {p.det_consistency:.3f}), separation "
              f"{p.separation:.2f} bits")
    front = pareto_front(points)
    print("pareto front:", [p.run for p in front])
    _chart(out / "tradeoff.png",
           lambda p: plot_tradeoff(points, p, sep_target=args.sep_target))


def cmd_interpolate(args):
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.perceptual.interpolate import interpolate_images

    cfg = PerceptualConfig()
    if args.ckpt == "random":
        # No trained SD weights ship with the repo (the reference loads its
        # own trained first-stage model, ldm_embedding_interpol.py:162-184).
        # ``--ckpt random`` runs the same pipeline on a seeded random init,
        # so the demo runs end to end; its output is labelled as such.
        import torch

        from svtpu_torch.models.autoencoder_kl import AutoencoderKL

        params = AutoencoderKL(
            cfg, device=args.device,
            generator=torch.Generator().manual_seed(args.seed)).state_dict()
    else:
        from svtpu_torch.perceptual.convert import (load_sd_first_stage,
                                                    load_torch_checkpoint)

        params = load_sd_first_stage(load_torch_checkpoint(args.ckpt))
    enc = PerceptualEncoder(params, cfg, batch_size=args.steps,
                            device=args.device)
    interpolate_images(enc, args.image_a, args.image_b, steps=args.steps,
                       mode=args.mode, out_path=args.out)
    print(f"wrote {args.out}" + (f" (random weights, seed {args.seed}: no "
                                 f"trained model)"
                                 if args.ckpt == "random" else ""))


# The commands whose svtpu counterpart builds a mesh over every chip of
# the host (its Trainer's or PerceptualEncoder's).
EVERY_RANK = ("train", "sweep", "embed", "interpolate")


def _on_every_rank(args) -> bool:
    """Whether the command runs on every rank under a launcher (data
    parallel, rank 0 writing) or on rank 0 alone: ``EVERY_RANK``, and
    ``eval-consistency`` where ``--sd-ckpt`` gives it the SD re-encode."""
    return args.cmd in EVERY_RANK or (
        args.cmd == "eval-consistency" and bool(args.sd_ckpt))


@contextlib.contextmanager
def _quiet_unless_main():
    """Standard output discarded on every rank but the main one: rank 0
    alone prints a command's results."""
    if distributed.is_main():
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _write_launches(directory) -> None:
    """This rank's kernel launches as ``launches_<rank>.json`` under
    ``directory``: each kernel wrapper's ``.launches`` since the process
    started (a launched command's own), ``flash_attention``'s by kernel, and
    the train step's and the encodes' graphs captured and replayed (a
    replay's launches are in the counts), for a caller that cannot read the
    counts of another process."""
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.models.encode_graph import EncodeGraph
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.training.step_graph import StepGraph

    counts = {fn.__name__: fn.launches for fn in (
        fused_conv01, lstm_binary_concrete, binary_concrete_fused,
        flash_attention)}
    path = Path(directory) / f"launches_{distributed.launched_rank()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "launches": counts,
        "flash_attention_by_kernel": dict(flash_attention.launches_by_kernel),
        "step_graphs": {"captures": StepGraph.captures,
                        "replays": StepGraph.replays},
        "encode_graphs": {"captures": EncodeGraph.captures,
                          "replays": EncodeGraph.replays}}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="svtpu_torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("extract", help="video -> frame dir")
    sp.add_argument("video_path")
    sp.add_argument("out_dir")
    sp.add_argument("--backend", default="cv2",
                    choices=["cv2", "native", "pyav", "decord"])
    sp.add_argument("--every-n", type=int, default=1)
    sp.add_argument("--limit", type=int)
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("convert", help="video container conversion")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--fourcc", default="MJPG")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("download-weights", help="fetch sd-v1-4.ckpt")
    sp.add_argument("out_dir")
    sp.set_defaults(fn=cmd_download_weights)

    sp = sub.add_parser("embed", help="frames -> perceptual embeddings .npy")
    sp.add_argument("frames_dir")
    sp.add_argument("out")
    sp.add_argument("--ckpt", required=True, help="sd checkpoint path")
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--deterministic", action="store_true",
                    help="posterior.mode() instead of sample()")
    sp.add_argument("--seed", type=int, default=0)
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_embed)

    sp = sub.add_parser("encode",
                        help="video/frames + ckpt -> packed symbols npz")
    sp.add_argument("input", help="video file or %%010d.jpg frame dir")
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--out", default="symbols.npz")
    sp.add_argument("--which", default="best", choices=["best", "latest"])
    sp.add_argument("--variant", default="contrastive",
                    choices=["simple", "contrastive", "triplet"])
    sp.add_argument("--latent-dim", type=int, default=25)
    sp.add_argument("--resolution", type=int, default=256,
                    help="model input side (must match the ckpt geometry)")
    sp.add_argument("--temperature", type=float, default=0.2)
    sp.add_argument("--noise-ratio", type=float, default=0.1)
    sp.add_argument("--deterministic", action="store_true",
                    help="hard-threshold sigmoid(h) with no sampling noise")
    sp.add_argument("--batch", type=int, default=64)
    sp.add_argument("--limit", type=int)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--resize-on", default="device",
                    choices=["device", "host"])
    sp.add_argument("--dtype", default="bfloat16")
    sp.add_argument("--lstm-residual", action="store_true")
    sp.add_argument("--lstm-layers", type=int)
    _add_video_args(sp, required=False)
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("train", help="train an RBVAE variant")
    train_sp = sp
    sp.add_argument("--preset", choices=sorted(TRAIN_PRESETS),
                    help="start from a measured recipe's flags "
                         "(RESULTS.md); explicit flags override")
    sp.add_argument("--multi", action="append", metavar="NAME=FRAMES_DIR",
                    help="repeatable: several videos on one global state "
                         "axis (svtpu-only; contrastive variant)")
    _add_video_args(sp, required=False)
    sp.add_argument("--variant", default="contrastive",
                    choices=["simple", "contrastive", "percep", "triplet"])
    sp.add_argument("--frames-dir")
    sp.add_argument("--embeddings", help=".npy for the percep variant")
    sp.add_argument("--resolution", type=int, default=256)
    sp.add_argument("--latent-dim", type=int, default=32)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--init-temp", type=float, default=1.0)
    sp.add_argument("--final-temp", type=float, default=0.5)
    sp.add_argument("--anneal-rate", type=float, default=1e-3)
    sp.add_argument("--num-steps-to-update", type=int, default=100)
    sp.add_argument("--bernoulli-p", type=float, default=0.1)
    sp.add_argument("--noise-ratio", type=float, default=0.1)
    sp.add_argument("--eval-noise-ratio", type=float, default=None,
                    help="noise for the selection metrics (default: "
                         "--noise-ratio); decouples noise-hardened "
                         "training from the eval protocol")
    sp.add_argument("--margin", type=float, default=0.2)
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--beta-kl", type=float, default=1.0)
    sp.add_argument("--contrast-on", default="h", choices=["h", "z", "p"])
    sp.add_argument("--triplet-distance", default="l2",
                    choices=["l2", "js"],
                    help="triplet objective distance: l2 (reference) or "
                         "the Bernoulli-JS variant (reference's dead code, "
                         "fixed)")
    sp.add_argument("--triplet-pull", type=float, default=0.0,
                    help="weight of an explicit anchor<->positive pull "
                         "(contrastive similar-pair term in p-space) added "
                         "to the triplet objective; 0 = reference behavior")
    sp.add_argument("--triplet-push", type=float, default=0.0,
                    help="weight of an ABSOLUTE dissimilar margin on the "
                         "triplet's own (anchor, negative) frames in "
                         "p-space; 0 = reference behavior")
    sp.add_argument("--contextfree-contrast", action="store_true",
                    help="also apply the contrastive margins to T=1 "
                         "encodes (what the eval protocol measures)")
    sp.add_argument("--select-by", default=None,
                    choices=["consistency", "val_loss", "separation",
                             "combined"],
                    help="model-selection metric (default: consistency, "
                         "or val_loss for triplet)")
    sp.add_argument("--sep-target", type=float, default=3.0,
                    help="separation (bits) saturating the combined score")
    sp.add_argument("--sep-aggregate", choices=["mean", "min"],
                    default="mean",
                    help="reduce the adjacent-pair Hamming vector by mean "
                         "(single-video default) or min")
    sp.add_argument("--restart-check-epoch", type=int, default=0,
                    help="auto-restart with a folded seed if the running-max "
                         "val separation is below --restart-min-sep after "
                         "this many epochs (0 disables)")
    sp.add_argument("--restart-min-sep", type=float, default=3.0)
    sp.add_argument("--max-restarts", type=int, default=3)
    sp.add_argument("--restart-on", choices=["mean", "min"], default="mean",
                    help="reduction of the per-pair Hamming vector the "
                         "basin check thresholds")
    sp.add_argument("--restart-reroll", choices=["init", "stream"],
                    default="init",
                    help="what a restart re-rolls: init (params/optimizer "
                         "only) or stream (also the train pair table and "
                         "noise seed)")
    sp.add_argument("--trap-guard-ratio", type=float, default=0.0,
                    help="keep the anneal floor at mean|h|/ratio (late-"
                         "anneal gradient-trap guard; 0 disables)")
    sp.add_argument("--l1-logits", type=float, default=0.0,
                    help="L1 coefficient on the binarization logits "
                         "(brake on the |h| growth driving the trap; "
                         "0 disables)")
    sp.add_argument("--val-every", type=int, default=1,
                    help="run the validation/probe block every N epochs "
                         "(the final and restart-check epochs are always "
                         "probed)")
    sp.add_argument("--no-fused-epoch", action="store_true",
                    help="run and read back each train step separately "
                         "instead of a fused epoch (step math and noise "
                         "streams are identical)")
    sp.add_argument("--lstm-residual", action="store_true",
                    help="identity paths around width-preserving LSTM "
                         "layers (svtpu extension; see DESIGN.md §8)")
    sp.add_argument("--lstm-layers", type=int,
                    help="override the variant's LSTM depth (1=simple, "
                         "2=contrastive/triplet, 4=percep)")
    sp.add_argument("--test-pct", type=float, default=0.1)
    sp.add_argument("--val-pct", type=float, default=0.1)
    sp.add_argument("--dtype", default="bfloat16")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--save-path")
    sp.add_argument("--history-out",
                    help="write per-epoch train+val metrics as JSONL")
    sp.add_argument("--log-dir")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in save-path")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("sweep", help="hyperparameter sweep")
    _add_video_args(sp)
    sp.add_argument("--variant", default="contrastive",
                    choices=["contrastive", "percep", "triplet",
                             "contrastive_z", "contrastive_p", "percep_p"])
    sp.add_argument("--frames-dir")
    sp.add_argument("--embeddings")
    sp.add_argument("--resolution", type=int, default=256)
    sp.add_argument("--test-pct", type=float, default=0.1)
    sp.add_argument("--val-pct", type=float, default=0.1)
    sp.add_argument("--count", type=int, default=10)
    sp.add_argument("--epochs", type=int,
                    help="override the space's epoch count")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--save-dir")
    sp.add_argument("--no-wandb", action="store_true")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_sweep)

    for name, fn in [("eval-consistency", cmd_eval_consistency),
                     ("eval-hamming", cmd_eval_hamming),
                     ("eval-projections", cmd_eval_projections),
                     ("eval-probe", cmd_eval_probe)]:
        sp = sub.add_parser(name)
        _add_video_args(sp, required=False)
        sp.add_argument("--multi", action="append",
                        metavar="NAME=FRAMES_DIR",
                        help="evaluate a multi-video checkpoint on the "
                             "global state axis")
        sp.add_argument("--frames-dir")
        sp.add_argument("--ckpt")
        sp.add_argument("--model", action="append",
                        help="repeatable side-by-side model spec "
                             "'ckpt=DIR[,variant=V][,latent=N][,name=S]"
                             "[,embeddings=PATH]' (combined chart/CSV, "
                             "like the reference's two-model comparison)")
        sp.add_argument("--variant", default="contrastive")
        sp.add_argument("--latent-dim", type=int, default=32)
        sp.add_argument("--resolution", type=int, default=256)
        sp.add_argument("--test-pct", type=float, default=0.1)
        sp.add_argument("--val-pct", type=float, default=0.1)
        sp.add_argument("--temperature", type=float, default=0.2)
        sp.add_argument("--trials", type=int, default=10)
        sp.add_argument("--out-dir", default="eval_out")
        sp.add_argument("--sd-ckpt",
                        help="SD checkpoint (percep-variant evals)")
        sp.add_argument("--embeddings",
                        help=".npy embeddings (percep-variant evals)")
        sp.add_argument("--lstm-residual", action="store_true",
                        help="model was trained with residual LSTM stacks")
        sp.add_argument("--lstm-layers", type=int,
                        help="override the variant's LSTM depth")
        _add_device_arg(sp)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("eval-tradeoff",
                        help="consistency-vs-separation curve over a "
                             "sweep's checkpoints")
    _add_video_args(sp)
    sp.add_argument("--frames-dir")
    sp.add_argument("--embeddings")
    sp.add_argument("--sweep-dir", default=None)
    sp.add_argument("--extra", action="append",
                    metavar="NAME:DIR:LATENT[:WHICH]",
                    help="additional standalone trainer checkpoints to plot")
    sp.add_argument("--variant", default="contrastive")
    sp.add_argument("--resolution", type=int, default=256)
    sp.add_argument("--test-pct", type=float, default=0.1)
    sp.add_argument("--val-pct", type=float, default=0.1)
    sp.add_argument("--temperature", type=float, default=0.2)
    sp.add_argument("--split", default="val", choices=["val", "test"])
    sp.add_argument("--sep-target", type=float, default=3.0)
    sp.add_argument("--out-dir", default="eval_out")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_eval_tradeoff)

    sp = sub.add_parser("interpolate", help="SD latent interpolation demo")
    sp.add_argument("image_a")
    sp.add_argument("image_b")
    sp.add_argument("--ckpt", required=True,
                    help="torch SD/AutoencoderKL checkpoint, or the "
                         "literal 'random' for a seeded random init "
                         "(no trained weights ship here)")
    sp.add_argument("--seed", type=int, default=0,
                    help="init seed for --ckpt random")
    sp.add_argument("--steps", type=int, default=8)
    sp.add_argument("--mode", default="slerp", choices=["lerp", "slerp"])
    sp.add_argument("--out", default="interpolation.png")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_interpolate)

    # Presets change the train subcommand's DEFAULTS, so they must be
    # applied before parsing — pre-scan argv for --preset.
    av = list(sys.argv[1:] if argv is None else argv)
    preset = None
    for i, a in enumerate(av):
        if a == "--preset" and i + 1 < len(av):
            preset = av[i + 1]
        elif a.startswith("--preset="):
            preset = a.split("=", 1)[1]
    if preset is not None:
        if preset not in TRAIN_PRESETS:
            raise SystemExit(f"unknown preset {preset!r}; "
                             f"choose from {sorted(TRAIN_PRESETS)}")
        train_sp.set_defaults(**TRAIN_PRESETS[preset])

    args = p.parse_args(argv)
    if os.environ.get("SVTPU_DETERMINISTIC") == "1":
        # Reproducible runs: PyTorch's deterministic algorithms (cuBLAS
        # reads its workspace setting at its first call).
        import torch

        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    has_device = "device" in vars(args)
    every_rank = _on_every_rank(args)
    own_group = every_rank and not dist.is_initialized()
    # Under a launcher a command that runs on every rank starts the process
    # group first: NCCL on this rank's card, gloo for --device cpu. Without
    # a launcher it is a no-op. No card exits here, before any file is read.
    try:
        if every_rank:
            distributed.initialize(device=args.device)
        if has_device:
            args.device = resolve_device(args.device)
    except NoCardError as e:
        raise SystemExit(f"{e} (on the command line: --device cpu)")
    if not every_rank:
        # A command of one card runs on rank 0 alone, with no group; the
        # other ranks return at once (the launcher waits for every rank,
        # and fails the job if one fails).
        out = args.fn(args) if distributed.launched_rank() == 0 else None
    else:
        try:
            with _quiet_unless_main():
                out = args.fn(args)
            distributed.barrier()
        finally:
            if own_group and dist.is_initialized():
                dist.destroy_process_group()
    if os.environ.get("SVTPU_LAUNCHES_DIR"):
        _write_launches(os.environ["SVTPU_LAUNCHES_DIR"])
    return out

if __name__ == "__main__":
    sys.exit(main())
