"""The frame-encode cell: a closed loop of one client sending batches of HD
frames through ``VideoSymbolPipeline.run_frames`` with SAM 2.1's image
encoder as its perceptual encoder (``svtpu_torch/perceptual/sam2.py``).

Traffic (the workload file's ``traffic``), as ``drivers/encode.py``'s:
``batches`` distinct batches of ``batch`` seeded uint8 frames of
``frame_hw`` (``make_frames``, in page-locked buffers with
``host_memory`` "pinned"), sent in turn; request ``i`` is
``run_frames(batch i mod batches, batch_index=i)``; every
``greedy_every``-th request goes to a pipeline with the noise off. Both
pipelines share one image encoder, whose features have no noise. Each
frame is resized to the encoder's square input and normalised on the
card, and has a code of its own.

The program's image encoder is imported here, when the harness loads the
driver: a checkout without it fails at once.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.clip_encode import pipelines
from portbench.drivers.encode import (REQUEST_SPAN, Latents, Tally,
                                      control_draws, make_frames,
                                      reference_h)
from portbench.reference import rbvae as ref
from portbench.reference import sam2 as refs
from svtpu_torch.config import Sam2HieraConfig
from svtpu_torch.models.encode_graph import EncodeGraph
from svtpu_torch.perceptual.sam2 import Sam2Encoder


def sam2_config(config: dict) -> Sam2HieraConfig:
    """The program's encoder configuration, field for field the file's."""
    return Sam2HieraConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in config["sam2"].items()})


def run(h) -> None:
    traffic, config, dev = h.cell["traffic"], h.config, h.device
    weights = ref.init_weights(config["model"], h.seed, dev,
                               h.cell.get("weight_gains"))
    vision = refs.init_weights(config["sam2"], h.seed + 2, dev)
    frames = make_frames(traffic, h.seed + 1, dev)
    cfg = sam2_config(config)
    enc = Sam2Encoder(vision, cfg, device=dev)
    if h.fault == "global_windowed":
        # A fault planted in the program: the global blocks attend inside
        # windows of the stage's window side instead of over the grid.
        for i in cfg.global_attention_blocks:
            enc.model.backbone.blocks[i].window = \
                cfg.window_size_per_stage[2]
    # Keeps the features the timed path handed to the RBVAE.
    keep = Latents(enc)
    noisy, greedy = pipelines(h, weights, enc)
    # Every key the window uses: eager, captured, replayed.
    for pipe in (noisy, greedy):
        for k in range(3):
            pipe.run_frames(frames[k % len(frames)], batch_index=2 ** 31 - k)
    captures = EncodeGraph.captures

    every, nb = traffic["greedy_every"], len(frames)
    ends, outputs = [], []
    # The features of the last request of each batch and kind, which the
    # check may pick: a copy on the card, taken after the request.
    kept: dict = {}
    h.open_window()
    i = 0
    while not h.window_over():
        is_greedy = i % every == every - 1
        pipe = greedy if is_greedy else noisy
        try:
            with torch.profiler.record_function(REQUEST_SPAN):
                codes = pipe.run_frames(frames[i % nb], batch_index=i)
            kept[(i % nb, is_greedy)] = (i, codes, keep.last.clone())
        except Exception as e:          # counted, and the run is not correct
            h.failed += 1
            h.note(f"request {i} failed: {e!r}")
            codes = None
        ends.append(time.perf_counter() - h.t0)
        outputs.append(codes is not None)
        i += 1
    window = h.close_window()
    h.attempted = i
    done = sum(outputs)
    h.e2e["encode_frames_per_s"] = done * traffic["batch"] / window
    h.work["frames"] = done * traffic["batch"]
    h.note(f"window {window:.3f} s: {i} requests, {h.failed} failed, "
           f"graph captures inside it: {EncodeGraph.captures - captures}; "
           f"requests a fifth of it: {np.histogram(ends, 5)[0].tolist()}")
    h.read_peak()
    for pipe in (noisy, greedy):
        pipe.drop_graphs()
    enc.drop_graphs()
    del noisy, greedy, enc, keep
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(h, weights, vision, frames, kept)


def check(h, weights: dict, vision: dict, frames: list, kept: dict) -> None:
    """Hold a sample of the window's answers, drawn from the seed, against
    the float32 reference. A greedy request's features must be the
    reference's (``feature_err``: the largest ``|f - f_ref| / |f_ref|`` of
    a token, over every frame) and each code bit must lie on the side of 0
    where the reference's ``h`` lies (``code_gap``, as the encode cells').
    A noisy request's bits must cross the reference's sign as often as the
    noise makes them (``flip_z``, of ``Tally``), the reference's ``h``
    worked out from the program's own features."""
    traffic, model = h.cell["traffic"], h.config["model"]
    scfg = h.config["sam2"]
    ref.exact_matmuls()
    rng = np.random.default_rng(h.seed)
    nb = len(frames)
    picks = []
    for is_greedy, n in ((True, traffic["check_greedy"]),
                         (False, traffic["check_noisy"])):
        pool = [kept[(b, is_greedy)] + (is_greedy,) for b in range(nb)
                if (b, is_greedy) in kept]
        if pool:
            sel = rng.choice(len(pool), min(n, len(pool)), replace=False)
            picks += [pool[j] for j in sorted(sel)]
    gap, ferr, malformed, flips, bits = 0.0, 0.0, 0, 0, 0
    tally = Tally()
    L = model["latent_dim"]
    scale = traffic["noise_ratio"]
    with torch.no_grad():
        for i, codes, feats, is_greedy in picks:
            x = torch.from_numpy(frames[i % nb]).to(h.device)
            if codes.shape != (traffic["batch"], L) or not np.isin(
                    codes, (0, 1)).all():
                malformed += 1
                continue
            if h.control:
                # The reference one precision below, in the program's
                # place: its own features, draws and bits.
                feats = refs.features(vision, scfg, x, h.control)
                hlow = reference_h(h, weights, feats, h.control)
                if not is_greedy:
                    u = control_draws(h, i, hlow.shape, 0)
                    hlow = hlow + scale * (torch.log(u + 1e-8)
                                           - torch.log(1 - u + 1e-8))
                codes = (hlow > 0).to(torch.uint8).cpu().numpy()
            b = torch.from_numpy(codes.astype(np.float32)).to(h.device)
            f = feats.float()
            if is_greedy:
                f_ref = refs.features(vision, scfg, x)
                ferr = max(ferr, float(((f - f_ref).norm(dim=-1)
                                        / f_ref.norm(dim=-1)).max()))
                href = reference_h(h, weights, f_ref, False)
                gap = max(gap, float(torch.relu(-(2 * b - 1) * href).max()))
                flips += int(((b > 0.5) != (href > 0)).sum())
                bits += b.numel()
            else:
                href = reference_h(h, weights, f, False)
                tally.bits(b, href, scale)
    h.note(f"greedy bits checked {bits}, off the reference's sign {flips}; "
           f"noisy bits off it {tally.off:.0f}, expected "
           f"{tally.expect:.1f} +- {tally.var ** 0.5:.1f}")
    # A greedy request's numbers only where one was checked.
    numbers = dict({"code_gap": gap, "feature_err": ferr} if bits else {},
                   **tally.numbers())
    for name, limit in h.limits.items():
        # A number with a limit that the sample could not give fails.
        h.compare(name, numbers.get(name, float("nan")), limit)
    for name, value in numbers.items():
        if name not in h.limits:
            h.note(f"not compared: {name} {value!r}")
    h.compare("malformed", malformed, 0)
    h.compare("unchecked", int(not picks), 0)
