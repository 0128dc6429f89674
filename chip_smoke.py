#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``svtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``svtpu_torch/csrc`` (into ``build/``),
prints each kernel's registers, spills and tensor-core instruction counts
(HMMA for mma.sync, HGMMA for wgmma, from ``cuobjdump --dump-sass``), and
holds each kernel against its plain PyTorch version, ``fused_conv01`` also
at B = 1, 7 and 133, ``flash_attention`` on every kernel its launcher
dispatches to and ``lstm_binary_concrete`` at every shape a path gives it
and a few ragged ones. Then it drives three paths
through ``VideoSymbolPipeline.run_frames``, each with its kernels switched
on and their launches counted:

  * the pixel path: the committed contrastive RBVAE
    (``results/p_hardened_params.npz``, latent 25, bf16, 256x256 RGB,
    batch 512) through ``fused_conv01`` and ``lstm_binary_concrete`` (the
    encoder LSTM with the sampler fused in); its noisy ``model.encode`` runs
    once under ``torch.cuda.set_sync_debug_mode("error")``;
  * the simple variant (seeded weights, latent 25, bf16, 64x64, batch
    512), which binarizes before its LSTM, through the standalone
    ``binary_concrete``;
  * a wide latent: the contrastive RBVAE at latent 75 (a width the sweeps
    search; seeded weights, f32, 256x256, batch 64), whose LSTM the fused
    kernel does not take, through ``fused_conv01``, the plain LSTM and the
    standalone ``binary_concrete``;
  * the SD first stage's GroupNorm+SiLU (``group_norm_silu``): the norm as
    the port ran it before the kernel (its device operations), the kernel
    against its plain version at every norm shape of the SD encoder at
    704x1280 in bf16 and f32, and both timed beside the library's
    ``F.group_norm`` and the bytes bound;
  * the perceptual path: the SD first stage at its published widths
    (``PerceptualConfig()``, bf16, seeded random weights) in
    ``PerceptualEncoder`` batches of 8 through ``group_norm_silu`` (22
    launches a batch, counted and traced) and ``flash_attention``, then the
    ``percep-flagship`` RBVAE (latent 25, 4-layer residual LSTM) through
    ``lstm_binary_concrete``, on 16 seeded 720x1280 frames; and one
    ``decode_latents`` (the decoder's attention);
  * the serving encodes as CUDA graphs (``phase_encode_graphs``), each
    path on the graph route (a graph a key: the first call eager, the
    second captured, then replays) held bit for bit against the eager
    route (``_graphed = False``): the pixel ``run_frames`` (the flagship at
    batch 512 with both kernels, the simple variant, latent 75; noisy and
    noise off), the percep ``run_frames`` (its RBVAE encode; the SD first
    stage runs eagerly), ``RBVAEBundle.encode`` with noise at
    two temperatures, and the trainer's probes over three epochs of
    annealed temperature on the bank and the host route; each key captured
    once, the launch counts of both routes equal, the kernels of traced
    pixel encode replays equal to the launches their captures
    counted, one replay of each kind under sync-debug "error", both routes
    timed, each key's capture seconds and pool bytes printed, and an
    encode that reads the card on the host failing its capture in a
    process of its own;
  * the training path: ``Trainer.train`` of the flagship preset (latent
    25, bf16, full width, batch 32) on a seeded synthetic video at the
    geometry of ``chinese_chess``, 3 fused epochs and the same 3 one step
    at a time under deterministic algorithms, every step after two eager
    warm-up steps a replay of the step's CUDA graph (counted), whose
    probes run ``fused_conv01`` and ``lstm_binary_concrete``; one f32 step
    on the card against the same step on the CPU; a fused epoch's steps
    under ``torch.cuda.set_sync_debug_mode("error")``; a graph's draws
    from a reseeded persistent generator; the trainer's capturable Adam
    against optax's formula; the graph route against the eager route bit
    for bit (parameters, Adam state, metric sums; bf16, f32, remat; across
    an anneal update, a raised temperature floor and a restart); a step
    that reads the card on the host failing its capture; one epoch of the
    ``percep-flagship`` preset on seeded SD-shaped latents; and the train's
    wall times (the benchmark's ``flagship-train`` cell times the step);
  * the evaluation path: the flagship read back through
    ``RBVAEBundle.from_checkpoint`` and evaluated by
    ``evaluate_consistency``, ``evaluate_hamming``,
    ``tradeoff.evaluate_checkpoint`` and ``codes_from_torch_checkpoint``
    (``fused_conv01``, ``lstm_binary_concrete``), the percep model's
    consistency through the SD first stage (``flash_attention``) and on
    perturbed latents, and the simple variant's encode (the standalone
    ``binary_concrete``), launches counted exactly; codes against the
    plain route, and per-trial times;
  * the command line: ``svtpu_torch.cli`` as a user runs it, no
    ``--device`` (``train`` with the ``percep-flagship`` and ``flagship``
    presets, ``encode`` of a JPEG directory, ``embed`` through the SD first
    stage, ``eval-hamming``, ``eval-consistency`` with both percep
    protocols, ``eval-tradeoff``), one command again in a subprocess; its
    ``encode`` and ``embed`` held bit for bit against the library calls,
    ``flash_attention``'s launches exact and every other kernel's 0 (the
    CLI keeps ``svtpu``'s kernel defaults), and each command's wall time;
  * the video path: ``run_video`` of the flagship (both kernels) on a
    seeded 480-frame 432x768 MJPG AVI decoded by cv2, its launches exact
    and its codes held against ``run_frames`` on the same decoded batches
    bit for bit, a missing file raising ``OSError``, the CLI's ``encode`` of
    the video; the int8 trunk's accumulators against their plain version
    and its code match, conv0 by space-to-depth and the decoder by
    depth-to-space against the direct convs, timed; and ``train --multi``
    with the ``multi-video`` preset, ``eval-hamming --multi`` and
    ``eval-consistency --multi`` on two seeded JPEG videos;
  * the rest of the port (``phase_rest_path``): ``environment_report``,
    ``summarize`` of the flagship, ``ema_update`` against a float64
    replay, the CLI's ``sweep`` (two trials), ``eval-tradeoff
    --sweep-dir`` and the sweep's resume, data and tensor parallelism on a
    single-rank NCCL group (the flagship ``Trainer`` on (1,) and (1, 1)
    meshes, a data-parallel ``PerceptualEncoder`` at the SD first stage's
    widths) against the runs without a mesh;
  * several cards (``phase_multi_card``), at world =
    ``torch.cuda.device_count()``: the CLI's ``train`` (bf16 and f32),
    ``embed``, ``sweep`` and ``eval-consistency --sd-ckpt`` under ``python3
    -m torch.distributed.run``, one rank a card, against the commands
    without a launcher (bit for bit at world 1, where the launched trains
    take the step graph and the references the eager route), one set of
    files written, each rank's launches and step graphs exact; at four
    cards or more the flagship ``Trainer`` on (world,) and (world/2, 2)
    meshes, the graph route against the eager route on the (world,) mesh
    bit for bit, and a data-parallel ``PerceptualEncoder`` with exact
    per-rank launches (on fewer cards the phase says it did not run them);
    a rank's import time, the train step on both routes, its gradient
    all-reduce against the NVLink bound and its collective alone, a trace
    of each route, and the SD encode at world 1 and world N.

Each path's deterministic codes are held against its plain path's, and the
paths and every kernel are timed beside the plain version, a library call
and the kernel's bound. Every check that fails raises, so the exit code is
non-zero; the last line of standard output is ``{"ok": true, "device":
{...}}`` only when every phase passed. Needs one CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import contextlib
import csv
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 512
LATENT = 25
TEMPERATURE = 0.2
# The perceptual path: 16 frames, SD-encoded in batches of 8; the SD
# encoder's bottleneck attention at 1280x704 is [B, N, D] = [8, 14080, 512].
PERCEP_FRAMES = 16
PERCEP_BATCH = 8
PERCEP_ATTN = (PERCEP_BATCH, 88 * 160, 512)
# V-JEPA 2's attention on the clip path, [clips * heads, tokens, head_dim]
# at 2 clips a request.
VIT_ATTN = (2 * 16, 8192, 64)
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The bf16 kernels meant for the tensor cores (substrings of their symbols).
TENSOR_CORE_KERNELS = ("fused_conv01_tc", "flash_d512_kernel",
                       "flash_bf16_kernel", "flash_mma_kernel",
                       "window_attn_kernel", "flash_d72_kernel")
# Each kernel's time before its redesign for Hopper (PERF.md §6, NVIDIA
# H100 80GB HBM3, 700.00 W): constants, printed on a line of their own
# beside this run's times and kept out of the kernels line. For
# lstm_binary_concrete, the two stages it replaces on the pixel path: the
# plain 2-layer encoder LSTM and the standalone binary_concrete kernel.
PREV_MS = {"fused_conv01": 10.507, "binary_concrete": 0.0287,
           "lstm_binary_concrete": 0.5085 + 0.0377,
           "flash_attention": 32.464, "flash_attention_d64": 15.1}
# lstm_binary_concrete's checks: (B, T, H, layers, residual); the pixel
# and percep paths' shapes first, then ragged T and batch, H = 32, and
# widths with two hidden units per lane: H = 50 (the benchmarks' latent;
# K padded to 52, lanes 18-31 idle in the second unit) and H = 64.
LSTM_SHAPES = ((BATCH, 1, LATENT, 2, False), (16, 1, LATENT, 4, True),
               (7, 5, LATENT, 1, False), (133, 3, 32, 3, True),
               (64, 3, 50, 2, False), (33, 2, 50, 4, True),
               (9, 2, 64, 2, True))
WIDE_LATENT = 75
# The training path: the ``flagship`` and ``percep-flagship`` presets
# (svtpu/cli.py:194-201, 215-221) as TrainConfig fields, on a synthetic
# video at the geometry of BUILTIN_VIDEOS["chinese_chess"].
FLAGSHIP_TRAIN = dict(
    batch_size=32, learning_rate=3e-4, init_temperature=2.0,
    final_temperature=0.2, anneal_rate=1e-3, num_steps_to_update=4,
    bernoulli_p=0.1, contrast_on="p", contextfree_contrast=True, margin=3.5,
    noise_ratio=0.3, eval_noise_ratio=0.1, beta_kl=0.2, alpha=4.0,
    select_by="combined", l1_logits=0.1, restart_check_epoch=250,
    restart_min_sep=10.0, max_restarts=3)
PERCEP_TRAIN = dict(
    batch_size=16, learning_rate=3e-4, init_temperature=2.0,
    final_temperature=0.2, anneal_rate=3e-4, num_steps_to_update=4,
    bernoulli_p=0.1, contrast_on="p", contextfree_contrast=True, margin=3.5,
    noise_ratio=0.3, eval_noise_ratio=0.1, beta_kl=0.2, alpha=4.0,
    select_by="combined")
TRAIN_EPOCHS = 3
# svtpu's train metric names for the flagship preset.
TRAIN_METRICS = {"total_loss", "recon_loss", "kl_loss", "contrast_loss",
                 "l1_loss", "temperature"}
# The video path: an MJPG AVI of chinese_chess's 480 frames at the main
# path's large frame size, decoded in run_video's default batches of 64.
VIDEO_HW = (432, 768)
VIDEO_BATCH = 64
# The card's host has g++ but neither libav nor libjpeg (headers or
# libraries), so the native IO library does not build there (PERF.md §6):
# run_video decodes with cv2 on the card (it takes the native reader only
# where that library is built), and the native cases run in the CPU tests
# only.


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, warmup: int = 8, trials: int = 5, iters: int = 10):
    """Median and spread ((max-min)/median) over ``trials`` of the mean
    CUDA-event time of ``iters`` back-to-back calls, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def phase_toolchain() -> str:
    from svtpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    card = card_line()
    print(f"toolchain: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]}, card {card}")
    print("host packages (importable): " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}"
        for m in ("PIL", "matplotlib", "sklearn", "cv2")))
    return card


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each kernel from ``-Xptxas -v``."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {"registers": None, "spill_bytes": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[fn]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def sass_counts(lib: Path) -> dict:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions of each kernel in a
    built library, from ``cuobjdump --dump-sass``."""
    from svtpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
                    break
    return counts


def phase_build() -> dict:
    """Build every kernel; print each kernel's registers, spills and
    tensor-core instruction counts. A spill in any kernel fails the run,
    and so does a bf16 tensor-core kernel with no HMMA or HGMMA
    instruction. Returns the counts by kernel symbol."""
    from svtpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s (rebuilt: {sorted(logs)})")
    usage = {}
    for name, log in logs.items():
        usage.update(ptxas_usage(log))
    report = {}
    for name in _build.SOURCES:
        for fn, n in sass_counts(_build._target(name)).items():
            use = usage.get(fn, {})
            report[fn] = dict(n, **use)
            print(f"  {name}: {fn}: registers {use.get('registers')}, spill "
                  f"bytes {use.get('spill_bytes')}, SASS HMMA {n['HMMA']}, "
                  f"HGMMA {n['HGMMA']}")
    for key in TENSOR_CORE_KERNELS:
        fns = [fn for fn in report if key in fn]
        require(len(fns) == 1, f"no single built kernel named {key}")
        r = report[fns[0]]
        require(r["HMMA"] + r["HGMMA"] > 0,
                f"{key}: no tensor-core instruction in its SASS")
    for fn, r in report.items():
        require(r.get("spill_bytes", 0) == 0, f"{fn}: ptxas spills")
    return report


def trunk_inputs(B, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 256, 256, 3, generator=g)
    w0 = torch.randn(64, 3, 3, 3, generator=g) * 0.1
    w1 = torch.randn(64, 64, 3, 3, generator=g) * 0.05
    b0, b1 = torch.randn(64, generator=g), torch.randn(64, generator=g)
    return [t.cuda() for t in (x, w0, b0, w1, b1)]


def conv_error(B: int, dt, seed: int):
    """fused_conv01 against its plain version on the same inputs: the max
    abs error and one bf16 step at the output's largest magnitude."""
    from svtpu_torch.ops.conv_trunk_cuda import (fused_conv01,
                                                 fused_conv01_plain)

    x, w0, b0, w1, b1 = trunk_inputs(B, seed)
    got = fused_conv01(x.to(dt), w0, b0, w1, b1)
    torch.cuda.synchronize()
    ref = fused_conv01_plain(x.to(dt), w0, b0, w1, b1)
    require(got.shape == ref.shape == (B, 64, 64, 64) and got.dtype == dt,
            "fused_conv01: shape or dtype")
    require(bool(torch.isfinite(got.float()).all()),
            "fused_conv01: non-finite output")
    err = float((got.float() - ref.float()).abs().max())
    return err, 2.0 ** -7 * float(ref.float().abs().max())


def phase_conv_kernel() -> dict:
    """fused_conv01 vs its plain version: f32 held to 1e-3 with TF32 off;
    bf16 held to two bf16 steps at the output's scale, since the two sum
    conv0 in another order and a conv0 value can round to a neighbouring
    bf16. At B=8 and at the main path's shape (B=512), and at B=1, 7 and
    133: fewer work items than SMs, and a remainder for the persistent
    grid of the bf16 kernel."""
    e32, _ = conv_error(8, torch.float32, 0)
    e16, step16 = conv_error(8, torch.bfloat16, 0)
    emain, step = conv_error(BATCH, torch.bfloat16, 1)
    print(f"check fused_conv01 vs plain: B=8 f32 max_abs_err {e32:.3e} "
          f"(limit 1e-3), B=8 bf16 max_abs_err {e16:.3e} (limit "
          f"{2 * step16:.3e}); B={BATCH} bf16 max_abs_err {emain:.3e} (limit "
          f"{2 * step:.3e}, two bf16 steps at the output's scale)")
    require(e32 < 1e-3, "fused_conv01 f32 disagrees")
    require(e16 <= 2 * step16, "fused_conv01 bf16 at B=8 disagrees")
    require(emain <= 2 * step, "fused_conv01 bf16 at the main path's shape "
            "disagrees")
    for B in (1, 7, 133):
        f32, _ = conv_error(B, torch.float32, 100 + B)
        bf16, step = conv_error(B, torch.bfloat16, 200 + B)
        print(f"check fused_conv01 vs plain, B={B}: f32 max_abs_err "
              f"{f32:.3e} (limit 1e-3), bf16 max_abs_err {bf16:.3e} (limit "
              f"{2 * step:.3e})")
        require(f32 < 1e-3, f"fused_conv01 f32 at B={B} disagrees")
        require(bf16 <= 2 * step, f"fused_conv01 bf16 at B={B} disagrees")
    return {"max_abs_err": emain}


def phase_sampler_kernel() -> dict:
    """binary_concrete_fused vs its plain version at the main path's shape
    and dtype ([512, 1, 25] bf16), and its distribution."""
    from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused,
                                               binary_concrete_fused_plain)

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(BATCH, 1, LATENT, generator=g).cuda() \
        .to(torch.bfloat16)
    hard = binary_concrete_fused(logits, 0, TEMPERATURE, noisy=False)
    hard_ref = binary_concrete_fused_plain(logits, 0, TEMPERATURE,
                                           noisy=False)
    require(torch.equal(hard, hard_ref), "sampler noise off: hard codes differ")
    soft = binary_concrete_fused(logits, 77, TEMPERATURE, 0.1, hard=False)
    soft_ref = binary_concrete_fused_plain(logits, 77, TEMPERATURE, 0.1,
                                           hard=False)
    err = float((soft.float() - soft_ref.float()).abs().max())
    noisy = binary_concrete_fused(logits, 77, TEMPERATURE, 0.1)
    noisy_ref = binary_concrete_fused_plain(logits, 77, TEMPERATURE, 0.1)
    noisy_mismatch = float((noisy != noisy_ref).float().mean())
    seed_t = torch.tensor([77], device="cuda")
    require(torch.equal(binary_concrete_fused(logits, seed_t, TEMPERATURE,
                                              0.1), noisy),
            "sampler: a seed tensor on the card gives other bits than the "
            "same seed as an int")
    # The temperature and the noise scale read from device memory (what a
    # graph of the encode holds) give the by-value launch's bits.
    temp_t = torch.tensor(TEMPERATURE, dtype=torch.float32, device="cuda")
    scale_t = torch.tensor(0.1, dtype=torch.float32, device="cuda")
    by_pointer = all(torch.equal(binary_concrete_fused(
        logits, seed_t, temp_t, scale_t, hard=h, noisy=n),
        binary_concrete_fused(logits, 77, TEMPERATURE, 0.1, hard=h, noisy=n))
        for h in (True, False) for n in (True, False))
    soft_ptr = binary_concrete_fused(logits, seed_t, temp_t, scale_t,
                                     hard=False)
    err_ptr = float((soft_ptr.float() - soft_ref.float()).abs().max())
    require(by_pointer and err_ptr <= 2.0 ** -8,
            "sampler: the temperature and noise scale read from the card "
            "give other bits than the same values by value")
    zeros = torch.zeros(256, 128, device="cuda")
    y = binary_concrete_fused(zeros, 3, 0.5, 1.0)
    p_one = float(y.mean())
    same = torch.equal(y, binary_concrete_fused(zeros, 3, 0.5, 1.0))
    differs = not torch.equal(y, binary_concrete_fused(zeros, 4, 0.5, 1.0))
    big = float(binary_concrete_fused(torch.full_like(zeros, 8.0), 5, 0.5,
                                      1.0).mean())
    print(f"check binary_concrete vs plain, [{BATCH},1,{LATENT}] bf16: noise "
          f"off hard bit-identical; noisy soft max_abs_err {err:.3e} (limit "
          f"2^-8, one bf16 step below 1); noisy hard mismatch vs the plain "
          f"Philox {noisy_mismatch:.3e} (limit 1e-3); zero logits p(1) "
          f"{p_one:.4f} (0.45-0.55); same seed same {same}; new seed new "
          f"{differs}; logits +8 p(1) {big:.4f} (> 0.95); a seed tensor "
          f"on the card gives the int seed's bits; the temperature and "
          f"noise scale as 0-dim tensors on the card give the by-value "
          f"bits (hard and soft, noisy and noise off), soft vs plain "
          f"{err_ptr:.3e}")
    require(err <= 2.0 ** -8, "sampler noisy soft values disagree")
    require(noisy_mismatch < 1e-3, "sampler noisy: disagrees with Philox")
    require(0.45 < p_one < 0.55, "sampler: p(1) at zero logits")
    require(same and differs, "sampler: seed determinism")
    require(big > 0.95, "sampler: monotonicity")
    return {"max_abs_err": err}


def seeded_lstm(H: int, layers: int, residual: bool, dt, seed: int):
    """The port's ``LSTM(H, H)`` on the card with weights drawn from a
    seed at torch's LSTM scale, U(-1/sqrt(H), 1/sqrt(H))."""
    from svtpu_torch.ops.lstm import LSTM

    lstm = LSTM(H, H, layers, residual, dt)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) / H ** 0.5)
    return lstm.cuda()


def lstm_inputs(B, T, H, dt, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, H, generator=g) * 1.5).cuda().to(dt)


def phase_lstm_kernel() -> dict:
    """lstm_binary_concrete vs its plain version (the port's LSTM, then
    binary_concrete_fused_plain) at every shape of ``LSTM_SHAPES``, in bf16
    and f32. h: bf16 within two bf16 steps at the LSTM's scale (cuBLAS sums
    the dot products in another order, so a rare element of h rounds to
    the neighbouring bf16 and carries on through the recurrence): at h's
    largest magnitude without the residual; with it, at the largest
    magnitude of h - x (the LSTMs' part) plus two steps at the element's
    own magnitude (the residual adds round there). f32 within 1e-5 with
    TF32 off. Codes, noise off and on: bit for bit those of
    binary_concrete_fused_plain and of the standalone kernel on the
    kernel's own h; soft values within 2^-8 (one bf16 step below 1)."""
    from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused,
                                               binary_concrete_fused_plain)
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete

    out = {}
    for i, (B, T, H, layers, residual) in enumerate(LSTM_SHAPES):
        name = f"[{B},{T},{H}] {layers} layers" + (" residual" if residual
                                                   else "")
        for dt in (torch.bfloat16, torch.float32):
            lstm = seeded_lstm(H, layers, residual, dt, 30 + i)
            x = lstm_inputs(B, T, H, dt, 40 + i)
            with torch.inference_mode():
                codes, h = lstm_binary_concrete(lstm, x, 0, TEMPERATURE,
                                                noisy=False, return_h=True)
                torch.cuda.synchronize()
                h_ref = lstm(x)
                require(codes.shape == h.shape == (B, T, H)
                        and codes.dtype == h.dtype == dt,
                        f"lstm_binary_concrete {name}: shape or dtype")
                require(bool(torch.isfinite(h.float()).all()),
                        f"lstm_binary_concrete {name}: non-finite h")
                dev = (h.float() - h_ref.float()).abs()
                err = float(dev.max())
                if dt == torch.float32:
                    limit = torch.full_like(dev, 1e-5)
                elif residual:
                    part = float((h_ref.float() - x.float()).abs().max())
                    limit = 2 * 2.0 ** -7 * (part + h_ref.float().abs())
                else:
                    limit = torch.full_like(
                        dev, 2 * 2.0 ** -7 * float(h_ref.float().abs().max()))
                within = bool((dev <= limit).all())
                limit = float(limit.min())
                seed_t = torch.tensor([1000 + i], device="cuda")
                same = torch.equal(codes, binary_concrete_fused_plain(
                    h, 0, TEMPERATURE, noisy=False))
                n_codes, n_h = lstm_binary_concrete(
                    lstm, x, seed_t, TEMPERATURE, 0.1, return_h=True)
                n_ref = binary_concrete_fused_plain(n_h, 1000 + i,
                                                    TEMPERATURE, 0.1)
                same_noisy = (torch.equal(n_codes, n_ref) and torch.equal(
                    n_codes, binary_concrete_fused(n_h, seed_t, TEMPERATURE,
                                                   0.1)))
                s_codes, s_h = lstm_binary_concrete(
                    lstm, x, seed_t, TEMPERATURE, 0.1, hard=False,
                    return_h=True)
                soft = float((s_codes.float() - binary_concrete_fused_plain(
                    s_h, 1000 + i, TEMPERATURE, 0.1, hard=False).float())
                    .abs().max())
                # The temperature and noise scale read from the card.
                temp_t = torch.tensor(TEMPERATURE, dtype=torch.float32,
                                      device="cuda")
                scale_t = torch.tensor(0.1, dtype=torch.float32,
                                       device="cuda")
                p_codes, p_h = lstm_binary_concrete(
                    lstm, x, seed_t, temp_t, scale_t, hard=False,
                    return_h=True)
                by_pointer = (torch.equal(p_codes, s_codes)
                              and torch.equal(p_h, s_h) and torch.equal(
                                  lstm_binary_concrete(lstm, x, seed_t,
                                                       temp_t, scale_t),
                                  n_codes))
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"check lstm_binary_concrete vs plain, {name} {tag}: h "
                  f"max_abs_err {err:.3e} (limit {limit:.3e}"
                  f"{' at the smallest |h|' if residual and tag == 'bf16' else ''}"
                  f"); codes vs "
                  f"binary_concrete_fused_plain on the kernel's h: noise off "
                  f"identical {same}, noisy identical (and to the standalone "
                  f"kernel) {same_noisy}; noisy soft max_abs_err {soft:.3e} "
                  f"(limit 2^-8); share of ones "
                  f"{float(n_codes.float().mean()):.3f}; the temperature "
                  f"and noise scale read from the card give the by-value "
                  f"bits {by_pointer}")
            require(by_pointer, f"lstm_binary_concrete {name} {tag}: the "
                    "temperature and noise scale read from the card give "
                    "other bits than by value")
            require(within, f"lstm_binary_concrete {name} {tag}: h "
                    "disagrees")
            require(same and same_noisy, f"lstm_binary_concrete {name} "
                    f"{tag}: codes differ from the sampler's on its h")
            require(soft <= 2.0 ** -8, f"lstm_binary_concrete {name} {tag}: "
                    "soft values disagree")
            if i == 0 and dt == torch.bfloat16:
                out["max_abs_err"] = err
    return out


def attention_inputs(B, N, D, dt, seed, spread=1.0, dominant=False):
    """q, k, v on the card. ``spread`` is the scores' standard deviation
    (q and k entries of variance ``spread``); ``dominant`` gives every
    query one key whose score stands ~``4 sqrt(D)`` above the rest."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, N, D, generator=g) for _ in range(3))
    q, k = q * spread ** 0.5, k * spread ** 0.5
    if dominant:
        perm = torch.randperm(N, generator=g)
        k[:, perm] = 4.0 * q / q.norm(dim=-1, keepdim=True) * D ** 0.5 \
            + 0.1 * k[:, perm]
    return [t.cuda().to(dt) for t in (q, k, v)]


def attention_error(B, N, D, dt, seed, **kw):
    """flash_attention against blocked_attention on the same inputs: the
    max abs error and one bf16 step at the output's largest magnitude."""
    from svtpu_torch.ops.attention import (blocked_attention, flash_attention,
                                           kernel_for)

    q, k, v = attention_inputs(B, N, D, dt, seed, **kw)
    which = kernel_for(dt, D)
    before = flash_attention.launches_by_kernel[which]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    require(flash_attention.launches_by_kernel[which] == before + 1,
            f"flash_attention [{B},{N},{D}] did not count a {which} launch")
    ref = blocked_attention(q, k, v)
    require(got.shape == ref.shape == (B, N, D) and got.dtype == dt,
            "flash_attention: shape or dtype")
    require(bool(torch.isfinite(got.float()).all()),
            "flash_attention: non-finite output")
    err = float((got.float() - ref.float()).abs().max())
    return err, 2.0 ** -7 * float(ref.float().abs().max())


def phase_attention_kernel() -> dict:
    """flash_attention vs its plain version: f32 at small shapes held to
    1e-3 (TF32 off); bf16 held to two bf16 steps at the output's scale (p
    is rounded to bf16 in the kernel and not in the plain version). Scores
    spread wide (std 8) and one case with a dominant key per row, so that a
    wrong running-max rescale shows. The bf16 cases at D = 512 run the
    D = 512 kernel, those at D = 64 (ragged against its 192-row blocks and
    128-key tiles, and V-JEPA 2's [32, 8192, 64]) the D = 64 kernel, the
    one at D = 96 the mma.sync kernel."""
    from svtpu_torch.ops.attention import kernel_for

    B, N, D = PERCEP_ATTN
    f32 = {"[2,300,64] f32 spread 8": (2, 300, 64, torch.float32, 10,
                                       dict(spread=8.0)),
           "[1,777,512] f32 spread 8": (1, 777, 512, torch.float32, 11,
                                        dict(spread=8.0))}
    bf16 = {f"[{B},{N},{D}] bf16 spread 8": (B, N, D, torch.bfloat16, 12,
                                             dict(spread=8.0)),
            f"[{B},{N},{D}] bf16 spread 1": (B, N, D, torch.bfloat16, 13,
                                             {}),
            "[2,1000,64] bf16 spread 8 (ragged)": (2, 1000, 64,
                                                   torch.bfloat16, 14,
                                                   dict(spread=8.0)),
            "[1,8191,64] bf16 (ragged)": (1, 8191, 64, torch.bfloat16, 19,
                                          {}),
            "[2,4000,64] bf16 dominant key (ragged)": (
                2, 4000, 64, torch.bfloat16, 20, dict(dominant=True)),
            "[32,8192,64] bf16 spread 8": (32, 8192, 64, torch.bfloat16, 22,
                                           dict(spread=8.0)),
            "[2,1000,512] bf16 spread 8 (ragged)": (2, 1000, 512,
                                                    torch.bfloat16, 18,
                                                    dict(spread=8.0)),
            "[2,2048,512] bf16 dominant key": (2, 2048, 512, torch.bfloat16,
                                               15, dict(dominant=True)),
            "[1,4000,96] bf16 dominant key (ragged)": (
                1, 4000, 96, torch.bfloat16, 16, dict(dominant=True))}
    out = {}
    for name, (b, n, d, dt, seed, kw) in f32.items():
        err, _ = attention_error(b, n, d, dt, seed, **kw)
        print(f"check flash_attention vs plain, {name}: max_abs_err "
              f"{err:.3e} (limit 1e-3)")
        require(err < 1e-3, f"flash_attention {name} disagrees")
    for name, (b, n, d, dt, seed, kw) in bf16.items():
        err, step = attention_error(b, n, d, dt, seed, **kw)
        out[name] = err
        print(f"check flash_attention vs plain, {name}, kernel "
              f"{kernel_for(dt, d)}: max_abs_err {err:.3e} (limit "
              f"{2 * step:.3e}, two bf16 steps at the output's scale)")
        require(err <= 2 * step, f"flash_attention {name} disagrees")
    return {"max_abs_err": out[f"[{B},{N},{D}] bf16 spread 8"],
            "max_abs_err_d64": out["[32,8192,64] bf16 spread 8"]}


# The SD encoder's norms at the percep cell's size (8 frames at 704x1280):
# name -> (channels, height, width, SiLU). Level 1's and 2's first norms
# take the previous level's width; the mid block's attention norm has no
# SiLU.
GN_BATCH = 8
GN_SHAPES = {"level 0": (128, 704, 1280, True),
             "level 1, first norm": (128, 352, 640, True),
             "level 1": (256, 352, 640, True),
             "level 2, first norm": (256, 176, 320, True),
             "level 2": (512, 176, 320, True),
             "level 3, mid, norm_out": (512, 88, 160, True),
             "mid attention": (512, 88, 160, False)}
# How many of the encoder's 22 norms a batch has at each shape.
GN_PER_BATCH = {"level 0": 4, "level 1, first norm": 1, "level 1": 3,
                "level 2, first norm": 1, "level 2": 3,
                "level 3, mid, norm_out": 9, "mid attention": 1}


def gn_inputs(c: int, h: int, w: int, dt, seed: int):
    """A channels-last activation ``[8, c, h, w]`` on the card with a mean
    and a scale of its own a channel (as a conv's output has), and the
    norm's float32 weight and bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shift = torch.randn(c, generator=g, device="cuda") * 2.0
    scale = torch.rand(c, generator=g, device="cuda") * 2.0 + 0.25
    x = torch.randn((GN_BATCH, h, w, c), generator=g, device="cuda")
    x = (x * scale + shift).to(dt).permute(0, 3, 1, 2)
    weight = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = torch.randn(c, generator=g, device="cuda") * 0.5
    return x, weight, bias


def device_ops(fn, n: int = 3) -> tuple:
    """The device operations of one call of ``fn`` (``n`` traced, after a
    warm-up): the ten longest as (operator -> kernel, launches a call, ms
    a call), and every one's launches a call."""
    import tempfile

    from svtpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with torch.inference_mode(), profiling.trace(tmp):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        tb = trace_breakdown(Path(tmp), n)
    return ([(name, k / n, ms / n) for name, k, ms in tb["top"]],
            {name: k / n for name, k in tb["counts"].items()})


def group_norm_diagnosis(card: str) -> dict:
    """One level-0 norm of the SD encoder as the port ran it before the
    kernel (``group_norm_silu_plain``: a cast to f32, ``F.group_norm``,
    ``F.silu``, a cast back) on a channels-last bf16 ``[8, 128, 704,
    1280]``, alone and followed by the 128 -> 128 conv that reads it, each
    with its device operations and its time."""
    from svtpu_torch.ops.conv import conv2d_torch
    from svtpu_torch.ops.group_norm import group_norm_silu_plain

    c, h, w, _ = GN_SHAPES["level 0"]
    x, weight, bias = gn_inputs(c, h, w, torch.bfloat16, 30)
    g = torch.Generator(device="cuda").manual_seed(31)
    cw = torch.randn(c, c, 3, 3, generator=g, device="cuda") * 0.03
    cb = torch.zeros(c, device="cuda")

    def norm():
        return group_norm_silu_plain(x, weight, bias, 1e-6, True,
                                     torch.bfloat16)

    def norm_conv():
        return conv2d_torch(norm(), cw, cb, 1, 1, torch.bfloat16)

    out = {}
    with torch.inference_mode():
        for name, fn in (("norm", norm), ("norm + conv", norm_conv)):
            ms, sp = cuda_ms(fn, warmup=2, trials=3, iters=3)
            ops, _ = device_ops(fn)
            out[name] = {"ms": ms, "ops": ops}
            print(f"group_norm before the kernel, {name} at [8, 128, 704, "
                  f"1280] bf16 channels-last: {ms:.3f} ms (spread {sp:.3f}) "
                  f"[{card}]; device ops a call: " + "; ".join(
                      f"{op} x{k:g} {t:.3f} ms" for op, k, t in ops))
    return out


def group_norm_error(name: str, dt) -> float:
    """The kernel against its plain version at one of ``GN_SHAPES`` in
    ``dt``: bf16 within two bf16 steps at the output's largest magnitude,
    f32 within 1e-5 of it; two launches bit for bit; one launch counted a
    call; the output channels-last. Returns the max abs error."""
    from svtpu_torch.ops.group_norm import (group_norm_silu,
                                            group_norm_silu_plain)

    c, h, w, silu = GN_SHAPES[name]
    x, weight, bias = gn_inputs(c, h, w, dt, 40 + c)
    before = group_norm_silu.launches
    with torch.inference_mode():
        got = group_norm_silu(x, weight, bias, 1e-6, silu, dt)
        again = group_norm_silu(x, weight, bias, 1e-6, silu, dt)
        want = group_norm_silu_plain(x, weight, bias, 1e-6, silu, dt)
    torch.cuda.synchronize()
    require(group_norm_silu.launches == before + 2,
            f"group_norm_silu {name}: launches not counted")
    require(got.dtype == dt and got.shape == x.shape
            and got.is_contiguous(memory_format=torch.channels_last),
            f"group_norm_silu {name}: dtype, shape or layout")
    require(torch.equal(got, again),
            f"group_norm_silu {name} {dt}: two launches differ")
    require(bool(torch.isfinite(got.float()).all()),
            f"group_norm_silu {name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    limit = 2 * 2.0 ** -7 * scale if dt == torch.bfloat16 else 1e-5 * scale
    print(f"check group_norm_silu vs plain, {name} [8, {c}, {h}, {w}] "
          f"{'SiLU' if silu else 'no SiLU'} {dt}: max_abs_err {err:.3e} "
          f"(limit {limit:.3e})")
    require(err <= limit, f"group_norm_silu {name} {dt} disagrees")
    return err


def group_norm_checks() -> dict:
    """Every shape of the cell in bf16 and f32; an NCHW input made
    channels-last by the wrapper, bit for bit; a float16 input refused."""
    from svtpu_torch.ops.group_norm import group_norm_silu

    errs = {name: group_norm_error(name, torch.bfloat16)
            for name in GN_SHAPES}
    for name in GN_SHAPES:
        group_norm_error(name, torch.float32)
    x, weight, bias = gn_inputs(256, 40, 72, torch.bfloat16, 50)
    with torch.inference_mode():
        cl = group_norm_silu(x, weight, bias, 1e-6, True, torch.bfloat16)
        nchw = group_norm_silu(x.contiguous(), weight, bias, 1e-6, True,
                               torch.bfloat16)
        try:
            group_norm_silu(x.half(), weight, bias, 1e-6, True, torch.half)
        except TypeError:
            pass
        else:
            require(False, "group_norm_silu took a float16 input")
    require(torch.equal(cl, nchw), "group_norm_silu: NCHW input differs")
    print("check group_norm_silu: an NCHW input gives the channels-last "
          "input's bits; float16 refused")
    return errs


def group_norm_times(card: str, build: dict, errs: dict) -> dict:
    """At every shape of the cell: the kernel (wrapper, back to back) and
    its device time (a CUDA graph of 20 launches), the plain version, the
    library's ``F.silu(F.group_norm(...))`` in bf16 on the channels-last
    input and on an NCHW copy, the bytes bound (one bf16 read and write an
    element); then a batch's 22 norms weighed by ``GN_PER_BATCH``, and the
    kernel's device operations at level 0."""
    from svtpu_torch.ops.group_norm import (group_norm_silu,
                                            group_norm_silu_plain)

    regs = {fn: r for fn, r in build.items() if "group_norm_silu" in fn}
    print("group_norm_silu kernels: " + "; ".join(
        f"{fn}: registers {r.get('registers')}, spill bytes "
        f"{r.get('spill_bytes')}" for fn, r in sorted(regs.items())))
    rows, batch = {}, dict.fromkeys(("ms", "device_ms", "plain_ms",
                                     "library_ms", "bound_ms"), 0.0)
    with torch.inference_mode():
        for name, (c, h, w, silu) in GN_SHAPES.items():
            x, weight, bias = gn_inputs(c, h, w, torch.bfloat16, 60 + c)
            xn = x.contiguous()

            def kernel():
                return group_norm_silu(x, weight, bias, 1e-6, silu,
                                       torch.bfloat16)

            wb, bb = weight.bfloat16(), bias.bfloat16()

            def library(t):
                y = F.group_norm(t, 32, wb, bb, 1e-6)
                return F.silu(y) if silu else y

            ms, sp = cuda_ms(kernel, warmup=3, trials=5, iters=5)
            dev, _ = graph_ms(kernel, n=20)
            plain, _ = cuda_ms(lambda: group_norm_silu_plain(
                x, weight, bias, 1e-6, silu, torch.bfloat16), warmup=2,
                trials=3, iters=3)
            lib, _ = cuda_ms(lambda: library(x), warmup=2, trials=3, iters=3)
            lib_nchw, _ = cuda_ms(lambda: library(xn), warmup=2, trials=3,
                                  iters=3)
            bound = 2 * 2 * x.numel() / PEAK_BYTES * 1e3
            rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain,
                              library_ms=lib, library_nchw_ms=lib_nchw,
                              bound_ms=bound, max_abs_err=errs[name])
            k = GN_PER_BATCH[name]
            for key in batch:
                batch[key] += k * rows[name][key]
            print(f"time: group_norm_silu {name} [8, {c}, {h}, {w}] bf16 "
                  f"{'SiLU' if silu else 'no SiLU'}: kernel {ms:.4f} ms "
                  f"(spread {sp:.3f}), device {dev:.4f} ms "
                  f"({bound / dev:.1%} of the bytes bound {bound:.4f} ms, "
                  f"{2 * 2 * x.numel() / dev / 1e6:.0f} GB/s at 4 B an "
                  f"element), plain {plain:.3f} ms, F.group_norm"
                  f"{'+F.silu' if silu else ''} bf16 {lib:.3f} ms "
                  f"(channels-last in), {lib_nchw:.3f} ms (NCHW in) "
                  f"[{card}]")
        c, h, w, _ = GN_SHAPES["level 0"]
        x, weight, bias = gn_inputs(c, h, w, torch.bfloat16, 70)
        ops, _ = device_ops(lambda: group_norm_silu(x, weight, bias, 1e-6,
                                                    True, torch.bfloat16))
    print(f"time: group_norm_silu, a batch's 22 norms: kernel "
          f"{batch['ms']:.3f} ms, device {batch['device_ms']:.3f} ms "
          f"({batch['bound_ms'] / batch['device_ms']:.1%} of the bytes bound "
          f"{batch['bound_ms']:.3f} ms), plain {batch['plain_ms']:.3f} ms, "
          f"library {batch['library_ms']:.3f} ms [{card}]")
    print("group_norm_silu at level 0, device ops a call: " + "; ".join(
        f"{op} x{k:g} {t:.3f} ms" for op, k, t in ops))
    return {"shapes": rows, "batch": batch, "registers": regs}


def phase_group_norm_kernel(card: str, build: dict) -> dict:
    """GroupNorm+SiLU: the norm as it ran before its kernel, the kernel
    against its plain version, and their times."""
    diagnosis = group_norm_diagnosis(card)
    errs = group_norm_checks()
    return dict(group_norm_times(card, build, errs), before=diagnosis)


def flagship(pallas: bool, dtype: str = "bfloat16"):
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.convert import from_jax_params, load_params_npz

    cfg = rbvae_variant("contrastive", LATENT, compute_dtype=dtype,
                        pallas_trunk=pallas, pallas_sampler=pallas)
    tree = load_params_npz(ROOT / "results" / "p_hardened_params.npz")
    return cfg, from_jax_params(tree, cfg)


def phase_main_path(card: str) -> dict:
    """The flagship encode through both kernels, counted; then the kernel
    path's deterministic codes against the plain path's, and one noisy
    ``model.encode`` under sync-debug mode "error": it must not make the
    host wait for the card."""
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.pipeline import VideoSymbolPipeline

    rng = np.random.default_rng(0)
    frames = {"256x256": rng.integers(0, 256, (BATCH, 256, 256, 3), np.uint8),
              "432x768": rng.integers(0, 256, (BATCH, 432, 768, 3), np.uint8)}
    cfg, sd = flagship(True)
    pipe = VideoSymbolPipeline(cfg, sd)

    counters = (fused_conv01, lstm_binary_concrete, binary_concrete_fused)
    for fn in counters:
        fn.launches = 0
    codes = {k: pipe.run_frames(v, i) for i, (k, v) in
             enumerate(frames.items())}
    torch.cuda.synchronize()
    launches = {"fused_conv01": fused_conv01.launches,
                "lstm_binary_concrete": lstm_binary_concrete.launches,
                "binary_concrete": binary_concrete_fused.launches}
    print(f"main path: run_frames x{len(frames)} ({', '.join(frames)}), "
          f"batch {BATCH}, noise on; launches {launches}")
    for name in ("fused_conv01", "lstm_binary_concrete"):
        require(launches[name] >= len(frames),
                f"main path launched {name} fewer than once per encode")
    for k, z in codes.items():
        require(z.shape == (BATCH, LATENT) and z.dtype == np.uint8
                and set(np.unique(z)) <= {0, 1}, f"noisy codes {k}")

    agree = {}
    det_kernel = VideoSymbolPipeline(cfg, sd, noise=False)
    det_plain = VideoSymbolPipeline(*flagship(False), noise=False)
    for k, v in frames.items():
        a, b = det_kernel.run_frames(v), det_plain.run_frames(v)
        agree[k] = float((a == b).mean())
    # float32 on a small batch: the kernel path against the plain path.
    small = frames["256x256"][:32]
    f32 = [VideoSymbolPipeline(*flagship(p, "float32"), noise=False)
           .run_frames(small) for p in (True, False)]
    agree["f32_32frames"] = float((f32[0] == f32[1]).mean())
    print(f"main path: deterministic code agreement, kernel path vs plain "
          f"path: {agree} (limit 0.98 bf16, 0.99 f32)")
    for k, frac in agree.items():
        require(frac >= (0.99 if k.startswith("f32") else 0.98),
                f"kernel path disagrees with the plain path on {k}")

    # Encode throughput, host uint8 frames in, codes out.
    x = frames["256x256"]
    for i in range(8):
        pipe.run_frames(x, i)
    torch.cuda.synchronize()
    reps, fps = 10, []
    for t in range(5):
        t0 = time.perf_counter()
        for i in range(reps):
            pipe.run_frames(x, t * reps + i)
        fps.append(BATCH * reps / (time.perf_counter() - t0))
    med = statistics.median(fps)
    print(f"time: encode (pipeline.run_frames, uint8 256x256 host frames in, "
          f"codes out), batch {BATCH}: {med:.1f} frames/s median of 5, "
          f"spread {(max(fps) - min(fps)) / med:.3f} [{card}]")

    # The model alone, frames already on the card as float.
    xd = torch.from_numpy(x).cuda().float().div(255.0)[:, None]
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            z = pipe.model.encode(xd, TEMPERATURE, True, 0.1, generator=gen)
            host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    require(z.shape == (BATCH, 1, LATENT), "noisy encode under sync debug")
    print(f"main path: noisy model.encode ran under "
          f"torch.cuda.set_sync_debug_mode('error') and raised nothing; the "
          f"call returned to the host after {host_ms:.3f} ms, the card "
          f"finished after {card_ms:.3f} ms [{card}]")
    with torch.inference_mode():
        ms, spread = cuda_ms(lambda: pipe.model.encode(
            xd, TEMPERATURE, True, 0.1, generator=gen), iters=5)
    print(f"time: model.encode on the card (f32 frames on the card), batch "
          f"{BATCH}: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} frames/s, spread "
          f"{spread:.3f} [{card}]")
    return {"launches": launches, "per_encode": {
        k: n / len(frames) for k, n in launches.items()}}


def phase_simple_path(card: str) -> dict:
    """The simple variant, which binarizes the conv logits before its LSTM,
    so its sampler is the standalone ``binary_concrete`` kernel: one noisy
    ``run_frames`` batch of 512 seeded 64x64 frames with seeded weights
    (bf16, latent 25), launches counted; then its deterministic codes
    against the plain path's."""
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.pipeline import VideoSymbolPipeline

    def cfg(kernel):
        return rbvae_variant("simple", LATENT, compute_dtype="bfloat16",
                             pallas_sampler=kernel)

    sd = Seq2SeqBinaryVAE(cfg(True), device="cpu",
                          generator=torch.Generator().manual_seed(22)
                          ).state_dict()
    frames = np.random.default_rng(3).integers(0, 256, (BATCH, 64, 64, 3),
                                               np.uint8)
    pipe = VideoSymbolPipeline(cfg(True), sd)
    for fn in (binary_concrete_fused, lstm_binary_concrete):
        fn.launches = 0
    codes = pipe.run_frames(frames, 0)
    torch.cuda.synchronize()
    launches = {"binary_concrete": binary_concrete_fused.launches,
                "lstm_binary_concrete": lstm_binary_concrete.launches}
    require(launches["binary_concrete"] >= 1,
            "simple path never launched binary_concrete")
    require(codes.shape == (BATCH, LATENT) and codes.dtype == np.uint8
            and set(np.unique(codes)) <= {0, 1}, "simple noisy codes")
    det = [VideoSymbolPipeline(cfg(k), sd, noise=False).run_frames(frames)
           for k in (True, False)]
    agree = float((det[0] == det[1]).mean())
    print(f"simple path: run_frames x1 (64x64, batch {BATCH}, bf16, seeded "
          f"weights, noise on); launches {launches}; share of ones "
          f"{codes.mean():.3f}; deterministic code agreement, kernel path vs "
          f"plain path {agree} (limit 0.98)")
    require(agree >= 0.98, "simple path: kernel path disagrees with the "
            "plain path")
    return {"launches": launches}


def phase_wide_path(card: str) -> dict:
    """A latent wider than the fused kernel takes: the contrastive RBVAE at
    latent 75 (seeded weights, f32, the pixel geometry), whose encode runs
    ``fused_conv01``, the plain encoder LSTM and the standalone
    ``binary_concrete`` kernel. One noisy ``run_frames`` batch of 64
    seeded 256x256 frames, launches counted; then its deterministic codes
    against the plain path's."""
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.pipeline import VideoSymbolPipeline

    def cfg(kernel):
        return rbvae_variant("contrastive", WIDE_LATENT,
                             compute_dtype="float32", pallas_trunk=kernel,
                             pallas_sampler=kernel)

    sd = Seq2SeqBinaryVAE(cfg(True), device="cpu",
                          generator=torch.Generator().manual_seed(23)
                          ).state_dict()
    frames = np.random.default_rng(4).integers(0, 256, (64, 256, 256, 3),
                                               np.uint8)
    pipe = VideoSymbolPipeline(cfg(True), sd)
    counters = {"fused_conv01": fused_conv01,
                "binary_concrete": binary_concrete_fused,
                "lstm_binary_concrete": lstm_binary_concrete}
    for fn in counters.values():
        fn.launches = 0
    codes = pipe.run_frames(frames, 0)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    require(launches["fused_conv01"] >= 1 and launches["binary_concrete"] >= 1,
            f"latent {WIDE_LATENT} path: a kernel was never launched")
    require(launches["lstm_binary_concrete"] == 0,
            f"latent {WIDE_LATENT} path launched the fused LSTM kernel")
    require(codes.shape == (64, WIDE_LATENT) and codes.dtype == np.uint8
            and set(np.unique(codes)) <= {0, 1}, "wide-latent noisy codes")
    det = [VideoSymbolPipeline(cfg(k), sd, noise=False).run_frames(frames)
           for k in (True, False)]
    agree = float((det[0] == det[1]).mean())
    print(f"wide-latent path: run_frames x1 (contrastive, latent "
          f"{WIDE_LATENT}, 256x256, batch 64, f32, seeded weights, noise on); "
          f"launches {launches}; share of ones {codes.mean():.3f}; "
          f"deterministic code agreement, kernel path vs plain path {agree} "
          f"(limit 0.99)")
    require(agree >= 0.99, f"latent {WIDE_LATENT} path: kernel path "
            "disagrees with the plain path")
    return {"launches": launches}


def percep_weights(frames: np.ndarray) -> dict:
    """Seeded random weights at the published widths: the SD first stage
    (``PerceptualConfig()``, ~84M parameters) and the percep RBVAE of the
    ``percep-flagship`` preset.

    Drawn at the scale a trained model keeps at its interfaces, so that the
    codes depend on the frames: the quant conv's mean rows are scaled so
    that the scaled latents of ``frames`` have unit std (what
    ``scale_factor`` gives SD's trained weights), and the RBVAE's encoder
    convs (He-uniform, x sqrt 6) and fc (unit variance, x sqrt 3) keep the
    signal's scale, where torch's default init shrinks it ~6x a layer.
    """
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.models.autoencoder_kl import (AutoencoderKL,
                                                   DiagonalGaussian)
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE

    cfg = PerceptualConfig()
    ae = AutoencoderKL(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(20))
    with torch.inference_mode():
        x = torch.from_numpy(frames).cuda().float() * (2.0 / 255.0) - 1.0
        mean = DiagonalGaussian.from_moments(ae.encode(x)).mean
        gain = 1.0 / float((cfg.scale_factor * mean).std())
    ae_sd = {k: v.clone() for k, v in ae.state_dict().items()}
    for k in ("quant_conv.weight", "quant_conv.bias"):
        ae_sd[k][:cfg.embed_dim] *= gain
    rb_sd = Seq2SeqBinaryVAE(percep_rbvae_cfg(True), device="cpu",
                             generator=torch.Generator().manual_seed(21)
                             ).state_dict()
    for k, v in rb_sd.items():
        if k.startswith("encoder_cnn.conv.") and k.endswith(".weight"):
            v *= 6 ** 0.5
    rb_sd["encoder_cnn.fc.weight"] *= 3 ** 0.5
    print(f"percep weights: quant_conv mean rows x {gain:.3f} for unit-std "
          f"scaled latents")
    return {"ae": ae_sd, "rbvae": rb_sd}


def percep_rbvae_cfg(kernel: bool, dtype: str = "bfloat16"):
    from svtpu_torch.config import rbvae_variant

    return rbvae_variant("percep", LATENT, compute_dtype=dtype,
                         lstm_residual=True, pallas_sampler=kernel)


@contextlib.contextmanager
def plain_norms():
    """The SD first stage's norms through ``group_norm_silu_plain`` on the
    card, for a path of plain versions to hold the kernels against."""
    from svtpu_torch.models import autoencoder_kl
    from svtpu_torch.ops.group_norm import group_norm_silu_plain

    kernel = autoencoder_kl.group_norm_silu
    autoencoder_kl.group_norm_silu = group_norm_silu_plain
    try:
        yield
    finally:
        autoencoder_kl.group_norm_silu = kernel


def percep_pipeline(weights: dict, kernel: bool, dtype: str = "bfloat16",
                    deterministic: bool = False):
    """``VideoSymbolPipeline(percep=PerceptualEncoder(...))``: both kernels
    on (``kernel``) or both plain versions."""
    from svtpu_torch.config import PerceptualConfig
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    enc = PerceptualEncoder(weights["ae"],
                            PerceptualConfig(compute_dtype=dtype),
                            batch_size=PERCEP_BATCH,
                            stochastic=not deterministic, use_kernel=kernel)
    return VideoSymbolPipeline(percep_rbvae_cfg(kernel, dtype),
                               weights["rbvae"], percep=enc,
                               noise=not deterministic)


def phase_percep_path(card: str) -> dict:
    """The perceptual path at full width: 16 seeded 720x1280 frames through
    ``run_frames`` (resize to 1280x704 on the card, SD encode in batches of
    8 with the norm and attention kernels, percep RBVAE encode with the
    encoder LSTM and the sampler in one kernel),
    then one ``decode_latents`` (the decoder's attention). Launches counted,
    one SD encode traced (its norms on the kernel alone); then the card's
    resize against the host's; then the kernel path against the plain path
    (the norms through ``plain_norms``), deterministic, and two encodes of
    the kernel path bit for bit."""
    from svtpu_torch.models.autoencoder_kl import GroupNormSiLU
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.group_norm import group_norm_silu
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.perceptual.embed import PerceptualEncoder

    t0 = time.perf_counter()
    frames = np.random.default_rng(7).integers(
        0, 256, (PERCEP_FRAMES, 720, 1280, 3), np.uint8)
    weights = percep_weights(frames[:2, :704])
    pipe = percep_pipeline(weights, True)
    print(f"percep path: weights and pipeline built in "
          f"{time.perf_counter() - t0:.1f} s")

    counters = (flash_attention, lstm_binary_concrete, binary_concrete_fused,
                fused_conv01, group_norm_silu)
    for fn in counters:
        fn.launches = 0
    by_kernel = flash_attention.launches_by_kernel
    for name in by_kernel:
        by_kernel[name] = 0
    torch.cuda.reset_peak_memory_stats()
    resizes = PerceptualEncoder.resizes
    codes = pipe.run_frames(frames, 0)
    require(PerceptualEncoder.resizes == resizes + 1,
            "percep run_frames: the HD batch was not resized on the card")
    z = pipe.percep.encode_frames(frames[:2, :704])
    pixels = pipe.percep.decode_latents(z)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "lstm_binary_concrete": lstm_binary_concrete.launches,
                "binary_concrete": binary_concrete_fused.launches,
                "fused_conv01": fused_conv01.launches,
                "group_norm_silu": group_norm_silu.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"percep path: run_frames x1 ({PERCEP_FRAMES} frames 720x1280, SD "
          f"batch {PERCEP_BATCH}, noise on) + encode_frames x1 (2 frames) + "
          f"decode_latents x1 (2 latents); launches {launches}, "
          f"flash_attention by kernel {dict(by_kernel)}; peak device "
          f"memory {peak:.2f} GiB")
    for name in ("flash_attention", "lstm_binary_concrete"):
        require(launches[name] > 0, f"percep path never launched {name}")
    require(by_kernel["bf16_d512"] == launches["flash_attention"],
            "percep path: attention not on the D = 512 kernel")
    # Every norm a kernel launch: 2 + 1 encoder batches, 1 decoder batch.
    model = pipe.percep.model
    norms = {part: sum(isinstance(m, GroupNormSiLU) for m in
                       getattr(model, part).modules())
             for part in ("encoder", "decoder")}
    require(norms["encoder"] == 22 and launches["group_norm_silu"]
            == 3 * norms["encoder"] + norms["decoder"],
            f"percep path: {launches['group_norm_silu']} group_norm_silu "
            f"launches for {norms} norms")
    _, ops = device_ops(
        lambda: pipe.percep.encode_frames(frames[:PERCEP_BATCH, :704]), 2)
    norm_ops = {op: k for op, k in ops.items() if "group_norm_silu" in op
                or "Moments" in op or "nchwToNhwc" in op
                or "nhwcToNchw" in op}
    print(f"percep path: a traced SD encode of {PERCEP_BATCH} frames, the "
          f"norms' and layout conversions' device ops a batch: {norm_ops}")
    require(not any("Moments" in op for op in ops)
            and sum(k for op, k in norm_ops.items()
                    if op.endswith("group_norm_silu_kernel")) == 22,
            "percep path: the SD encode's norms not all on the kernel")
    require(codes.shape == (PERCEP_FRAMES, LATENT) and codes.dtype == np.uint8
            and set(np.unique(codes)) <= {0, 1}, "percep noisy codes")
    print(f"percep path: codes: share of ones {codes.mean():.3f}, bits that "
          f"differ across the {PERCEP_FRAMES} frames "
          f"{int((codes.min(0) != codes.max(0)).sum())} of {LATENT}; "
          f"latents std {z.std():.3f}")
    require(z.shape == (2, 88, 160, 4) and np.isfinite(z).all(),
            "percep latents")
    require(pixels.shape == (2, 704, 1280, 3) and np.isfinite(pixels).all()
            and pixels.min() >= 0.0 and pixels.max() <= 1.0,
            "percep decoded pixels")

    sd_frames = percep_resize_against_host(pipe, weights, frames, card)

    # The slice against its plain path: AE at its mode, noise off.
    agree, rel = {}, {}
    for dtype, n in (("bfloat16", PERCEP_FRAMES), ("float32", 4)):
        det = {k: percep_pipeline(weights, k, dtype, deterministic=True)
               for k in (True, False)}
        for p in det.values():
            # Eager: phase_encode_graphs holds the graph route against
            # this one.
            p._graphed = False
        lat, c = {}, {}
        for k, p in det.items():
            with contextlib.nullcontext() if k else plain_norms():
                lat[k] = p.percep.encode_frames(sd_frames[:n])
                c[k] = p.run_frames(frames[:n])
        require(np.array_equal(lat[True], det[True].percep.encode_frames(
            sd_frames[:n])), f"percep latents: two {dtype} encodes differ")
        rel[dtype] = float(np.abs(lat[True] - lat[False]).max()
                           / np.abs(lat[False]).max())
        agree[dtype] = float((c[True] == c[False]).mean())
        del det
    print(f"percep path: kernel path vs plain path, deterministic: latents "
          f"max abs err / max |latent| {rel} (limit 0.05 bf16, 1e-3 f32); "
          f"code agreement {agree} (limit 0.98 bf16 on {PERCEP_FRAMES} "
          f"frames, 0.99 f32 on 4)")
    require(rel["bfloat16"] <= 0.05 and rel["float32"] <= 1e-3,
            "percep latents: kernel path disagrees with the plain path")
    require(agree["bfloat16"] >= 0.98 and agree["float32"] >= 0.99,
            "percep codes: kernel path disagrees with the plain path")

    # Times: run_frames, encode_frames per batch of 8, decode.
    for i in range(2):
        pipe.run_frames(frames, i)
    fps = []
    for t in range(5):
        t0 = time.perf_counter()
        pipe.run_frames(frames, 10 + t)
        fps.append(PERCEP_FRAMES / (time.perf_counter() - t0))
    med = statistics.median(fps)
    print(f"time: percep run_frames ({PERCEP_FRAMES} uint8 720x1280 host "
          f"frames in, codes out), SD batch {PERCEP_BATCH}: {med:.2f} "
          f"frames/s median of 5, spread {(max(fps) - min(fps)) / med:.3f} "
          f"[{card}]")
    batch = sd_frames[:PERCEP_BATCH]
    enc_ms = []
    for t in range(7):
        t0 = time.perf_counter()
        pipe.percep.encode_frames(batch)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    enc_ms = enc_ms[2:]
    med_enc = statistics.median(enc_ms)
    print(f"time: PerceptualEncoder.encode_frames, {PERCEP_BATCH} uint8 "
          f"1280x704 host frames in, latents out: {med_enc:.3f} ms per batch "
          f"median of 5, spread {(max(enc_ms) - min(enc_ms)) / med_enc:.3f} "
          f"[{card}]")
    return {"launches": launches, "fps": med, "encode_ms": med_enc,
            "weights": weights}


def percep_resize_against_host(pipe, weights: dict, frames: np.ndarray,
                               card: str) -> np.ndarray:
    """``run_frames``' resize on the card against ``resize_u8`` on the
    host: the pixels (at most one grey level apart, at most 1% differing),
    then, with the AE at its mode and noise off, the latents of the two
    resized batches (relative gap at most 0.05, the benchmark's
    ``latent_err`` limit) and their codes through ``run_frames`` (at least
    98% of bits agree); ``PerceptualEncoder.resizes`` a request; the
    resize's time on the card (CUDA events) beside the host's, a batch of
    ``PERCEP_BATCH``. Returns the card-resized frames, on the host."""
    from svtpu_torch.ops.image import resize_u8
    from svtpu_torch.perceptual.embed import PerceptualEncoder

    hw = pipe.percep.input_hw
    x = torch.from_numpy(frames)
    host = resize_u8(x, hw).numpy()
    sd_frames = resize_u8(x.cuda(), hw).cpu().numpy()
    diff = np.abs(sd_frames.astype(np.int16) - host)
    share = float((diff != 0).mean())
    print(f"percep resize: card vs host ({len(frames)} frames 720x1280 -> "
          f"{hw[1]}x{hw[0]}): max difference {int(diff.max())} grey "
          f"level(s), share of pixels that differ {share:.5f}")
    require(diff.max() <= 1 and share <= 0.01,
            "percep resize: the card's differs from the host's")

    det = percep_pipeline(weights, True, deterministic=True)
    lat = {k: det.percep.encode_frames(f)
           for k, f in (("card", sd_frames), ("host", host))}
    rel = float(np.abs(lat["card"] - lat["host"]).max()
                / np.abs(lat["host"]).max())
    per_request = []
    codes = {}
    for k, f in (("run_frames", frames), ("host", host)):
        before = PerceptualEncoder.resizes
        codes[k] = det.run_frames(f)
        per_request.append(PerceptualEncoder.resizes - before)
    agree = float((codes["run_frames"] == codes["host"]).mean())
    print(f"percep resize: latents card-resized vs host-resized, max abs "
          f"gap / max |latent| {rel:.3e} (limit 0.05); codes of run_frames "
          f"vs the host-resized frames agree {agree:.4f} (limit 0.98); "
          f"PerceptualEncoder.resizes a request: HD frames "
          f"{per_request[0]}, frames at the SD input {per_request[1]}")
    require(rel <= 0.05 and agree >= 0.98,
            "percep resize: the card's route strays from the host's")
    require(per_request == [1, 0], f"percep resize: resizes a request "
            f"{per_request}, expected [1, 0]")
    del det

    batch = x[:PERCEP_BATCH]
    on_card = batch.cuda()
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        resize_u8(batch, hw)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    card_ms, spread = cuda_ms(lambda: resize_u8(on_card, hw))
    print(f"time: percep resize of {PERCEP_BATCH} uint8 720x1280 frames to "
          f"{hw[1]}x{hw[0]}: card {card_ms:.3f} ms (CUDA events, spread "
          f"{spread:.3f}), host {statistics.median(host_ms):.1f} ms (median "
          f"of 5) [{card}]")
    return sd_frames


CLIP_FRAMES = 128


def phase_clip_path(card: str) -> dict:
    """The clip path at full width, as the clip cell drives it: 128 seeded
    uint8 720x1280 frames in page-locked memory (two 64-frame clips)
    through ``run_frames`` of a percep RBVAE over V-JEPA 2's encoder
    (``ClipEncoder``, seeded weights at the published widths), three
    requests: eager, captured, replayed. Every attention launch must be
    the D = 64 kernel's, one a layer and request, and none the mma.sync
    kernel's; a tubelet's code is on both of its frames."""
    from svtpu_torch.config import VJEPA2Config, rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.models.vjepa2 import VJEPA2
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.perceptual.clip import ClipEncoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    t0 = time.perf_counter()
    vcfg = VJEPA2Config()
    params = VJEPA2(vcfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(30)
                    ).state_dict()
    enc = ClipEncoder(params, vcfg)
    rb = rbvae_variant("percep", LATENT, lstm_residual=True,
                       in_channels=vcfg.hidden_size,
                       out_channels=vcfg.hidden_size,
                       input_hw=vcfg.grid[1:], compute_dtype="bfloat16",
                       pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(rb, device="cpu",
                          generator=torch.Generator().manual_seed(31)
                          ).state_dict()
    pipe = VideoSymbolPipeline(rb, sd, percep=enc, batch=CLIP_FRAMES)
    buf = torch.empty((CLIP_FRAMES, 720, 1280, 3), dtype=torch.uint8,
                      pin_memory=True)
    buf.copy_(torch.from_numpy(np.random.default_rng(32).integers(
        0, 256, buf.shape, np.uint8)))
    frames = buf.numpy()
    print(f"clip path: encoder, pipeline and frames built in "
          f"{time.perf_counter() - t0:.1f} s")

    by_kernel = flash_attention.launches_by_kernel
    for name in by_kernel:
        by_kernel[name] = 0
    flash_attention.launches = 0
    requests = 3
    torch.cuda.reset_peak_memory_stats()
    codes = [pipe.run_frames(frames, i) for i in range(requests)]
    torch.cuda.synchronize()
    counts = dict(by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"clip path: run_frames x{requests} ({CLIP_FRAMES} frames "
          f"720x1280, eager, captured, replayed); flash_attention by kernel "
          f"{counts}, {counts['bf16_d64'] / requests:.0f} a request; peak "
          f"device memory {peak:.2f} GiB")
    require(counts["bf16_d64"] == requests * vcfg.num_hidden_layers,
            f"clip path: {vcfg.num_hidden_layers} D = 64 launches a request")
    require(counts["bf16"] == 0 and flash_attention.launches
            == counts["bf16_d64"], "clip path: attention off the D = 64 "
            "kernel")
    for c in codes:
        require(c.shape == (CLIP_FRAMES, LATENT) and set(np.unique(c))
                <= {0, 1} and np.array_equal(c[0::2], c[1::2]),
                "clip path codes")

    fps = []
    for t in range(5):
        t0 = time.perf_counter()
        pipe.run_frames(frames, 10 + t)
        fps.append(CLIP_FRAMES / (time.perf_counter() - t0))
    med = statistics.median(fps)
    print(f"time: clip run_frames ({CLIP_FRAMES} uint8 720x1280 pinned host "
          f"frames in, codes out): {med:.2f} frames/s median of 5, spread "
          f"{(max(fps) - min(fps)) / med:.3f} [{card}]")
    pipe.drop_graphs()
    enc.drop_graphs()
    del pipe, enc, params, buf
    torch.cuda.empty_cache()
    return {"launches": counts, "requests": requests, "fps": med}


SAM2_FRAMES = 32
# SAM 2.1 Hiera-L's attention blocks on one frame, as (windows x heads, Nq,
# Nk) at D = 72 by the token grid's side, the key window (0: global),
# whether the queries are pooled, the heads; and how many blocks of each.
SAM2_SHAPES = {"(2048, 64, 64)": ((256, 8, False, 2), 2),
               "(4096, 16, 64)": ((256, 8, True, 4), 1),
               "(4096, 16, 16)": ((128, 4, False, 4), 5),
               "(8192, 4, 16)": ((128, 4, True, 8), 1),
               "(128, 256, 256)": ((64, 16, False, 8), 32),
               "(8, 4096, 4096)": ((64, 0, False, 8), 3),
               "(256, 64, 256)": ((64, 16, True, 16), 1),
               "(256, 64, 64)": ((32, 8, False, 16), 3)}


def sam2_attention_times(card: str) -> list:
    """Each of SAM 2's attention shapes at the cell's 32 frames, q, k and v
    read in place from one bf16 qkv grid: the D = 72 kernel's time
    (``window_attention``, CUDA events), its operations and bytes, its
    bound and share of it; ``scaled_dot_product_attention`` on the same
    windows copied out (the copies not timed); the plain version (f32,
    TF32 off) and the kernel's largest error against it, beside two bf16
    steps at the output's scale."""
    from svtpu_torch.ops.attention import (window_attention,
                                           window_attention_plain)
    from svtpu_torch.ops.attention import _windows

    rows = []
    for name, ((side, window, pooled, heads), blocks) in SAM2_SHAPES.items():
        C = 72 * heads
        g = torch.Generator(device="cuda").manual_seed(side + heads)
        qkv = torch.randn(SAM2_FRAMES, side, side, 3 * C, generator=g,
                          device="cuda").bfloat16()
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        if pooled:
            q = q.reshape(SAM2_FRAMES, side // 2, 2, side // 2, 2,
                          C).amax(dim=(2, 4))
        ms, spread = cuda_ms(lambda: window_attention(q, k, v, heads, window),
                             warmup=3, trials=3, iters=5)
        wk = window or side
        wq = wk // 2 if pooled else wk
        qw = _windows(q, heads, wq, wq).unflatten(0, (-1, 1))
        kw, vw = (_windows(t, heads, wk, wk).unflatten(0, (-1, 1))
                  for t in (k, v))
        try:
            lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
                qw, kw, vw), warmup=2, trials=3, iters=3)
        except RuntimeError as e:       # a grid past the library's limits
            print(f"scaled_dot_product_attention {name}: {e}")
            lib_ms = float("nan")
        B, nq, nk = qw.shape[0], wq * wq, wk * wk
        ops = 4.0 * B * nq * nk * 72
        nbytes = 2.0 * B * 72 * (2 * nq + 2 * nk)
        bound = max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        got = window_attention(q, k, v, heads, window)
        t0 = time.perf_counter()
        want = window_attention_plain(q.float(), k.float(), v.float(), heads,
                                      window)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got.float() - want).abs().max())
        step = 2.0 ** -7 * float(want.abs().max())
        require(err <= 2 * step, f"window_attention {name}: error {err} over "
                f"two bf16 steps {2 * step}")
        row = {"shape": name, "blocks": blocks, "kernel_ms": ms,
               "spread": spread, "tflops": ops / ms / 1e9,
               "bound_ms": bound, "share": bound / ms,
               "bound_by": "bytes" if nbytes / PEAK_BYTES
               > ops / PEAK_BF16_FLOPS else "operations",
               "sdpa_ms": lib_ms, "plain_ms": plain_ms, "max_abs_err": err,
               "two_steps": 2 * step}
        rows.append(row)
        print(f"time: window_attention {name} x{SAM2_FRAMES} frames "
              f"({blocks} blocks a frame): kernel {ms:.4f} ms (spread "
              f"{spread:.3f}), {row['tflops']:.1f} TFLOP/s, bound "
              f"{bound:.4f} ms by {row['bound_by']}, {100 * row['share']:.1f}% "
              f"of it; scaled_dot_product_attention {lib_ms:.4f} ms; plain "
              f"{plain_ms:.1f} ms; max abs err {err:.3e} (two bf16 steps "
              f"{2 * step:.3e}) [{card}]")
        del qkv, q, k, v, qw, kw, vw, got, want
        torch.cuda.empty_cache()
    per_request = sum(r["kernel_ms"] * r["blocks"] for r in rows)
    print(f"time: window_attention, a 32-frame request's 48 launches: "
          f"{per_request:.2f} ms of kernels, bound "
          f"{sum(r['bound_ms'] * r['blocks'] for r in rows):.2f} ms [{card}]")
    return rows


def phase_sam2_path(card: str) -> dict:
    """The image path at full width, as the SAM 2 cell drives it: 32 seeded
    uint8 720x1280 frames in page-locked memory through ``run_frames`` of
    a percep RBVAE over SAM 2.1's Hiera-L image encoder (``Sam2Encoder``,
    seeded weights at the published widths), three requests: eager,
    captured, replayed. Each request must launch the windowed D = 72
    kernel once a windowed or query-pooled block (45) and the global one
    once a global block (3), and nothing else of ``flash_attention``'s
    (no mma.sync ``bf16`` launch); one code a frame."""
    from svtpu_torch.config import Sam2HieraConfig, rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.models.sam2 import Sam2ImageEncoder
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.perceptual.sam2 import Sam2Encoder
    from svtpu_torch.pipeline import VideoSymbolPipeline

    t0 = time.perf_counter()
    scfg = Sam2HieraConfig()
    params = Sam2ImageEncoder(scfg, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(
                                  40)).state_dict()
    enc = Sam2Encoder(params, scfg)
    rb = rbvae_variant("percep", LATENT, lstm_residual=True,
                       in_channels=scfg.fpn_hidden_size,
                       out_channels=scfg.fpn_hidden_size,
                       input_hw=(scfg.feature_hw, scfg.feature_hw),
                       compute_dtype="bfloat16", pallas_sampler=True)
    sd = Seq2SeqBinaryVAE(rb, device="cpu",
                          generator=torch.Generator().manual_seed(41)
                          ).state_dict()
    pipe = VideoSymbolPipeline(rb, sd, percep=enc, batch=SAM2_FRAMES)
    buf = torch.empty((SAM2_FRAMES, 720, 1280, 3), dtype=torch.uint8,
                      pin_memory=True)
    buf.copy_(torch.from_numpy(np.random.default_rng(42).integers(
        0, 256, buf.shape, np.uint8)))
    frames = buf.numpy()
    print(f"sam2 path: encoder, pipeline and frames built in "
          f"{time.perf_counter() - t0:.1f} s")

    by_kernel = flash_attention.launches_by_kernel
    for name in by_kernel:
        by_kernel[name] = 0
    flash_attention.launches = 0
    requests = 3
    torch.cuda.reset_peak_memory_stats()
    codes = [pipe.run_frames(frames, i) for i in range(requests)]
    torch.cuda.synchronize()
    counts = dict(by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_global = len(scfg.global_attention_blocks)
    n_window = len(scfg.blocks) - n_global
    print(f"sam2 path: run_frames x{requests} ({SAM2_FRAMES} frames "
          f"720x1280, eager, captured, replayed); flash_attention by kernel "
          f"{counts}; peak device memory {peak:.2f} GiB")
    require(counts["bf16_d72_window"] == requests * n_window,
            f"sam2 path: {n_window} windowed D = 72 launches a request")
    require(counts["bf16_d72"] == requests * n_global,
            f"sam2 path: {n_global} global D = 72 launches a request")
    require(flash_attention.launches == requests * (n_window + n_global)
            and counts["bf16"] == 0, "sam2 path: attention off the D = 72 "
            "kernels")
    for c in codes:
        require(c.shape == (SAM2_FRAMES, LATENT)
                and set(np.unique(c)) <= {0, 1}, "sam2 path codes")

    fps = []
    for t in range(5):
        t0 = time.perf_counter()
        pipe.run_frames(frames, 10 + t)
        fps.append(SAM2_FRAMES / (time.perf_counter() - t0))
    med = statistics.median(fps)
    print(f"time: sam2 run_frames ({SAM2_FRAMES} uint8 720x1280 pinned host "
          f"frames in, codes out): {med:.2f} frames/s median of 5, spread "
          f"{(max(fps) - min(fps)) / med:.3f} [{card}]")
    pipe.drop_graphs()
    enc.drop_graphs()
    del pipe, enc, params, buf
    torch.cuda.empty_cache()
    return {"launches": counts, "requests": requests, "fps": med,
            "attention": sam2_attention_times(card)}


def graph_keys(owner) -> list:
    """Each key of the encode graphs of ``owner`` and of its perceptual
    encoder: its tag, inputs, eager calls, captures, replays, the capture's
    seconds and the pool's bytes."""
    out = []
    for o in (owner, getattr(owner, "percep", None)):
        if o is not None and o._encode_graphs is not None:
            out += o._encode_graphs.report()
    return out


def key_line(k: dict) -> str:
    pool = "not named" if k["pool_bytes"] is None \
        else f"{k['pool_bytes'] / 2 ** 20:.1f} MiB"
    return (f"{k['tag']} {k['inputs']} {k['static']}: eager "
            f"{k['eager']}, captures {k['captures']}, replays "
            f"{k['replays']}, capture {k['capture_s']:.3f} s, pool {pool}")


def encode_routes(name: str, make, run, calls: list, keys: int,
                  card: str) -> dict:
    """One serving path on both encode routes. ``make()`` builds its owner
    twice: on the graph route (the default on the card) and on the eager
    route (``_graphed = False``, the reference). ``run(owner, call)`` runs
    each of ``calls`` and returns its result on the host. Holds the two
    routes' results equal bit for bit; their kernel launches equal (the
    graph route's counted at the capture and added at every replay, the
    eager route's each a launch), so the counts equal the kernels that
    ran; and each of the graph route's ``keys`` keys run eagerly once,
    captured once and replayed at every later call. Returns the graph
    route's owner."""
    from svtpu_torch.ops.cuda_graph import Launches

    counters = kernel_counters()
    launches = Launches(counters.values())
    out = {}
    for graphed in (False, True):       # the reference's memory goes first
        owner = make()
        owner._graphed = graphed
        torch.cuda.synchronize()
        before = launches.read()
        t0 = time.perf_counter()
        res = [run(owner, c) for c in calls]
        torch.cuda.synchronize()
        out[graphed] = (res, dict(zip(counters, (
            n for n, _ in launches.since(before)))), time.perf_counter() - t0)
        if not graphed:
            del owner
            torch.cuda.empty_cache()
    (gres, gl, gs), (eres, el, es) = out[True], out[False]
    same = len(gres) == len(eres) and all(
        np.array_equal(a, b) for a, b in zip(gres, eres))
    report = graph_keys(owner)
    once = len(report) == keys and all(
        k["eager"] == 1 and k["captures"] == 1 and k["replays"] >= 1
        for k in report)
    print(f"graph route: {name}: {len(calls)} calls; graph = eager bit for "
          f"bit: {same}; launches on the graph route {gl}, eager {el}; "
          f"{len(report)} key(s) (expected {keys}): "
          + "; ".join(key_line(k) for k in report)
          + f"; wall, first calls and capture included: graph {gs:.3f} s, "
          f"eager {es:.3f} s [{card}]")
    require(same, f"{name}: the graph route differs from the eager route")
    require(gl == el and any(gl.values()), f"{name}: launches counted on "
            f"the graph route {gl}, on the eager route {el}")
    require(once, f"{name}: each key must run eagerly once, be captured "
            f"once and replay after")
    return owner


def replay_quietly(graphs, *args, **kwargs) -> torch.Tensor:
    """One call of an ``EncodeGraph`` whose key is captured, its inputs on
    the card, under sync-debug "error": a copy of the static output, made
    on the card. Raises if the call made the host wait or did not
    replay."""
    from svtpu_torch.models.encode_graph import EncodeGraph

    replays = EncodeGraph.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = graphs(*args, **kwargs).clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(EncodeGraph.replays == replays + 1,
            "a call under sync debug did not replay its graph")
    return out


# The kernels each wrapper may launch, by their labels in a trace
# (``kernel_label``, the namespace dropped): one a launch.
WRAPPER_KERNELS = {
    "fused_conv01": ("fused_conv01_tc", "fused_conv01_kernel"),
    "lstm_binary_concrete": ("lstm_binary_concrete_kernel",),
    "binary_concrete_fused": ("binary_concrete_kernel",),
    "flash_attention": ("flash_d512_kernel", "flash_bf16_kernel",
                        "flash_mma_kernel", "flash_f32_kernel",
                        "window_attn_kernel", "flash_d72_kernel")}


def traced_replays(graphs, tag: str, shape: list, fn, n: int, what: str,
                   card: str) -> dict:
    """Trace ``n`` calls of ``fn``, each one replay of the captured key of
    ``graphs`` tagged ``tag`` whose input has ``shape``, and hold the
    kernels that ran in the trace, wrapper by wrapper, against ``n`` times
    the launches the key's capture counted (``replay_launches``): the
    launches the graph route's counts add at a replay are then measured,
    not inferred. Returns the trace's ``trace_breakdown``."""
    import tempfile

    from svtpu_torch.utils import profiling

    def key():
        (k,) = [k for k in graphs.report() if k["tag"] == tag
                and k["inputs"][0] == list(shape) and k["captures"]]
        return k

    replays = key()["replays"]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.inference_mode(), profiling.trace(tmp):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        tb = trace_breakdown(Path(tmp), n, by_op=False)
    k = key()
    ran = {w: sum(c for label, c in tb["counts"].items()
                  if label.split("::")[-1] in labels)
           for w, labels in WRAPPER_KERNELS.items()}
    want = {w: n * k["replay_launches"][w] for w in WRAPPER_KERNELS}
    print(f"check {what}: {n} replays of {tag} {shape} traced; the kernels "
          f"that ran, by wrapper, {ran}; {n} x the launches its capture "
          f"counted {want} [{card}]")
    require(k["replays"] == replays + n, f"{what}: the {n} traced calls "
            f"were not {n} replays")
    require(ran == want and any(want.values()), f"{what}: the kernels that "
            f"ran in {n} replays differ from the launches counted for them")
    return tb


def route_times(owner, fn, n: int = 6) -> dict:
    """Host seconds of ``fn()`` (ending with its results on the host) on
    each route of ``owner``, medians of ``n`` taken in turns (graph, eager,
    eager, graph, ...), after two warm-up calls a route (a key's first call
    and its capture)."""
    times = {True: [], False: []}
    for graphed in (True, False):
        owner._graphed = graphed
        fn()
        fn()
    for i in range(n):
        for graphed in ((True, False) if i % 2 == 0 else (False, True)):
            owner._graphed = graphed
            t0 = time.perf_counter()
            fn()
            times[graphed].append(time.perf_counter() - t0)
    owner._graphed = True
    return {"graph": statistics.median(times[True]),
            "eager": statistics.median(times[False])}


def phase_encode_graphs(card: str, weights: dict) -> dict:
    """The serving encodes as CUDA graphs (``models/encode_graph.py``),
    each path on the graph route held against the eager route bit for bit
    (``encode_routes``): the pixel ``run_frames`` (the flagship at batch 512
    with both kernels, also at 432x768 through the resize; the simple
    variant; latent 75), noisy and noise off; the percep ``run_frames``
    (the percep RBVAE's graph; the SD first stage runs eagerly on both
    routes); ``RBVAEBundle.encode`` with noise at two
    temperatures and without; the trainer's probes across three epochs of
    annealed temperature with the weights updated in place between them,
    on the bank route and the host route. One replay of each kind under
    sync-debug "error"; 5 pixel encode replays traced, their
    kernels held against the launches counted for them
    (``traced_replays``); each path timed on both routes; a capture that
    fails, in a process of its own."""
    import dataclasses
    import tempfile

    from svtpu_torch import batch_seed
    from svtpu_torch.config import TrainConfig, rbvae_variant
    from svtpu_torch.evaluation.common import (RBVAEBundle, chunk_encoder,
                                               padded_chunks)
    from svtpu_torch.evaluation.consistency import (PERTURBATIONS,
                                                    evaluate_consistency)
    from svtpu_torch.models.encode_graph import EncodeGraph
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.image import resize_u8
    from svtpu_torch.pipeline import VideoSymbolPipeline, preprocess
    from svtpu_torch.training.schedules import temperature_schedule
    from svtpu_torch.training.trainer import Trainer
    from svtpu_torch.utils import profiling

    t_phase = time.perf_counter()
    counters = kernel_counters()
    zero_counts(counters)
    captures0 = EncodeGraph.captures
    rng = np.random.default_rng(12)
    px = rng.integers(0, 256, (BATCH, 256, 256, 3), np.uint8)
    px_large = rng.integers(0, 256, (BATCH, 432, 768, 3), np.uint8)
    px_small = rng.integers(0, 256, (BATCH, 64, 64, 3), np.uint8)

    def frames_run(pipe, call):
        return pipe.run_frames(*call)

    # Pixel paths, noisy and noise off.
    cfg, sd = flagship(True)
    simple_cfg = rbvae_variant("simple", LATENT, compute_dtype="bfloat16",
                               pallas_sampler=True)
    simple_sd = Seq2SeqBinaryVAE(simple_cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(22)
                                 ).state_dict()
    wide_cfg = rbvae_variant("contrastive", WIDE_LATENT,
                             compute_dtype="float32", pallas_trunk=True,
                             pallas_sampler=True)
    wide_sd = Seq2SeqBinaryVAE(wide_cfg, device="cpu",
                               generator=torch.Generator().manual_seed(23)
                               ).state_dict()
    pipe = None
    for noise in (True, False):
        tag = "noisy" if noise else "noise off"
        calls = [(px, i) for i in range(3)]
        if noise:
            calls += [(px_large, 3), (px_large, 4)]
        # One key for both frame sizes: batches over COPY_CHUNK_BYTES are
        # copied in chunks and resized before the graph, whose input is
        # then the resized [BATCH, 256, 256, 3] batch (pipeline._staged).
        owner = encode_routes(
            f"pixel run_frames, flagship, batch {BATCH}, bf16, both "
            f"kernels, 256x256{' and 432x768' if noise else ''}, {tag}",
            lambda: VideoSymbolPipeline(cfg, sd, noise=noise), frames_run,
            calls, 1, card)
        if noise:
            pipe = owner
        else:
            owner.drop_graphs()
        del owner
        encode_routes(
            f"pixel run_frames, simple variant, 64x64, batch {BATCH}, bf16, "
            f"{tag}",
            lambda: VideoSymbolPipeline(simple_cfg, simple_sd, noise=noise),
            frames_run, [(px_small, i) for i in range(3)], 1, card)
        encode_routes(
            f"pixel run_frames, latent {WIDE_LATENT}, f32, batch 64, {tag}",
            lambda: VideoSymbolPipeline(wide_cfg, wide_sd, noise=noise),
            frames_run, [(px[:64], i) for i in range(3)], 1, card)
    # The captured key's input: a batch over COPY_CHUNK_BYTES reaches the
    # graph resized, in f32 (pipeline._staged).
    x_dev = preprocess(torch.from_numpy(px).cuda(),
                       tuple(pipe.cfg.input_hw)).contiguous()
    z = replay_quietly(pipe.encode_graphs(), "run_frames", pipe.model,
                       (pipe.hard, pipe.noise), pipe._codes, (x_dev,),
                       pipe.temperature, pipe.noise_ratio,
                       batch_seed(pipe.seed, 7))
    require(np.array_equal(z.cpu().numpy(), pipe.run_frames(px, 7)),
            "pixel: the replay under sync debug differs")
    pipe.drop_graphs()

    # The perceptual path: the percep RBVAE's graph, on the SD first
    # stage's latents (eager on both routes), of the frames resized on the
    # card as run_frames resizes them.
    frames = np.random.default_rng(7).integers(
        0, 256, (PERCEP_FRAMES, 720, 1280, 3), np.uint8)
    sd_frames = resize_u8(torch.from_numpy(frames).cuda(),
                          (704, 1280)).cpu().numpy()

    def percep_run(p, call):
        if call == "latents":
            return p.percep.encode_frames(sd_frames)
        return p.run_frames(frames, call)

    ppipe = encode_routes(
        f"percep run_frames ({PERCEP_FRAMES} frames 720x1280, SD batch "
        f"{PERCEP_BATCH}, stochastic, noisy codes) x2, then the SD latents "
        f"of {PERCEP_FRAMES} frames", lambda: percep_pipeline(weights, True),
        percep_run, [0, 1, "latents"], 1, card)
    latents = ppipe.percep.encode_frames(sd_frames)
    codes = replay_quietly(ppipe.encode_graphs(), "run_frames", ppipe.model,
                           (ppipe.hard, ppipe.noise), ppipe._codes,
                           (torch.from_numpy(latents).cuda(),),
                           ppipe.temperature, ppipe.noise_ratio,
                           batch_seed(ppipe.seed, 0))
    require(np.array_equal(codes.cpu().numpy(), ppipe.run_frames(frames, 0)),
            "percep: the replay under sync debug differs")
    t = route_times(ppipe, lambda: ppipe.run_frames(frames, 0))
    ppipe.drop_graphs()
    del ppipe
    torch.cuda.empty_cache()
    print(f"time: percep run_frames ({PERCEP_FRAMES} uint8 720x1280 host "
          f"frames in, codes out): graph route "
          f"{PERCEP_FRAMES / t['graph']:.2f} frames/s, eager "
          f"{PERCEP_FRAMES / t['eager']:.2f} [{card}]")

    # Evaluation: the bundle's chunks, with noise at two temperatures and
    # without.
    eval_px = rng.integers(0, 256, (300, 256, 256, 3), np.uint8)
    bundle = encode_routes(
        "evaluation RBVAEBundle.encode, 300 uint8 frames in chunks of 128 "
        "(the last padded), the flagship, noise on at temperatures 0.2 and "
        "0.5, then noise off",
        lambda: RBVAEBundle(cfg, sd),
        lambda b, c: b.encode(eval_px, temperature=c[0], noise=c[1], seed=4),
        [(0.2, True), (0.5, True), (0.2, False), (0.5, False)], 2, card)
    got = replay_quietly(
        bundle.encode_graphs(), "encode_chunks", bundle.model,
        (True, True),
        chunk_encoder(bundle.model, bundle.prep, True, True),
        (torch.from_numpy(eval_px[:128]).cuda(),), 0.5, 0.1,
        batch_seed(4, 0))
    require(np.array_equal(got.cpu().numpy(), bundle.encode(
        eval_px[:128], temperature=0.5, seed=4)),
        "evaluation: the replay under sync debug differs")

    # The trainer's probes: three epochs of annealed temperature, the
    # weights moved in place between them (Adam's updates, as a graph sees
    # them), on the bank route and on the host route.
    meta, splits, ids, states = train_video()
    store = MemoryStore(video_frames(meta, states), ids)
    tcfg = TrainConfig(**FLAGSHIP_TRAIN)
    temps = [temperature_schedule(s, tcfg.init_temperature,
                                  tcfg.final_temperature, tcfg.anneal_rate,
                                  tcfg.num_steps_to_update)
             for s in (1, 600, 1200)]
    model = Seq2SeqBinaryVAE(cfg, device="cuda")
    epochs = [{k: v * (1 + 0.002 * e) if v.is_floating_point() else v
               for k, v in sd.items()} for e in range(3)]
    val_idx = splits.flat("val")

    def probe_run(tr, e):
        model.load_state_dict(epochs[e])       # in place: same addresses
        rows = (store.rows(np.asarray(val_idx)) if tr._bank is not None
                else store.gather(np.asarray(val_idx)))
        return np.concatenate([
            tr._val_codes(model, val_idx, temps[e], True, e),
            tr._val_codes(model, val_idx, temps[e], False, e),
            tr.encode_frames(model, rows, temps[e], hard=False, seed=e,
                             from_bank=tr._bank is not None)])

    probes = {}
    for stage in ("auto", False):
        route = "bank" if stage else "host"
        probes[route] = encode_routes(
            f"trainer probes ({route} route; {len(val_idx)} val frames; "
            f"consistency, separation and soft codes) at the anneal's "
            f"temperatures {[round(t, 4) for t in temps]}, the weights "
            f"updated in place between epochs",
            lambda: Trainer(cfg, dataclasses.replace(tcfg,
                                                     stage_frames=stage),
                            store, splits, meta.flags, device="cuda"),
            probe_run, [0, 1, 2], 3, card)
    tr = probes["bank"]
    require(tr._bank is not None and probes["host"]._bank is None,
            "probes: the routes did not stage as asked")
    _, first, n = next(padded_chunks(store.rows(np.asarray(val_idx)), 128))
    enc_noise = tcfg.eval_noise_ratio
    got = replay_quietly(
        tr.encode_graphs(), "encode_chunks", model, (True, True),
        chunk_encoder(model, tr._chunk_prep(True), True, True),
        (torch.from_numpy(first).cuda(),), temps[2], enc_noise,
        batch_seed(2, 0))
    require(np.array_equal(got.cpu().numpy()[:n], tr.encode_frames(
        model, first[:n], temps[2], seed=2, from_bank=True)),
        "probes: the replay under sync debug differs")
    launches = read_counts(counters)
    captures = EncodeGraph.captures - captures0
    print(f"check replays under torch.cuda.set_sync_debug_mode('error'): "
          f"pixel run_frames, the percep RBVAE encode, an evaluation "
          f"chunk and a bank-route probe chunk each "
          f"replayed and raised nothing, equal to the same calls from the "
          f"host; the phase captured {captures} graphs, launched {launches} "
          f"[{card}]")

    # Times, each path on both routes (host clock to results on the host,
    # medians taken in turns, ``route_times``; the encode with CUDA
    # events).
    gen = torch.Generator(device="cuda")
    graphs = pipe.encode_graphs()

    def graph_encode():
        return graphs("run_frames", pipe.model, (pipe.hard, pipe.noise),
                      pipe._codes, (x_dev,), pipe.temperature,
                      pipe.noise_ratio, 5)

    def eager_encode():
        gen.manual_seed(5)
        return pipe._codes((x_dev,), pipe.temperature, pipe.noise_ratio, gen)

    with torch.inference_mode():
        g_ms, g_sp = cuda_ms(graph_encode, iters=5)
        e_ms, e_sp = cuda_ms(eager_encode, iters=5)
        # One encode at a time, the host waiting for each: what a caller
        # that reads every batch's codes pays.
        lat = {True: [], False: []}
        for i in range(20):
            for graphed in ((True, False) if i % 2 == 0 else (False, True)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (graph_encode if graphed else eager_encode)()
                torch.cuda.synchronize()
                lat[graphed].append((time.perf_counter() - t0) * 1e3)
    for route, fn in (("graph", graph_encode), ("eager", eager_encode)):
        if route == "graph":
            tb = traced_replays(graphs, "run_frames", [BATCH, 256, 256, 3],
                                fn, 5, "the pixel encode's replays", card)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                with torch.inference_mode(), profiling.trace(tmp):
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                tb = trace_breakdown(Path(tmp), 5, by_op=False)
        print(f"trace: 5 pixel encodes at batch {BATCH} on the {route} "
              f"route: window {tb['window_ms']:.3f} ms, the card busy "
              f"{tb['busy_share']:.1%}, device time {tb['kernel_ms_sum']:.3f} "
              f"ms in {tb['device_events']} events; by kernel: "
              + "; ".join(f"{name} x{n} {ms:.4f} ms"
                          for name, n, ms in tb["top"]) + f" [{card}]")
    print(f"time: the pixel encode on the card (uint8 frames on the card in, "
          f"codes out: to_float01, model.encode with both kernels, the "
          f"cast), batch {BATCH}: back to back (CUDA events) graph route "
          f"{g_ms:.4f} ms (spread {g_sp:.3f}; a replay and the copy into "
          f"its input), eager route {e_ms:.4f} ms (spread {e_sp:.3f}); one "
          f"at a time, host clock to the card's end, median of 20 in turns: "
          f"graph {statistics.median(lat[True]):.4f} ms, eager "
          f"{statistics.median(lat[False]):.4f} ms [{card}]")
    t = route_times(pipe, lambda: [pipe.run_frames(px, i) for i in range(5)])
    print(f"time: pixel run_frames (uint8 256x256 host frames in, codes "
          f"out), batch {BATCH}, 5 batches: graph route "
          f"{5 * BATCH / t['graph']:.1f} frames/s, eager route "
          f"{5 * BATCH / t['eager']:.1f} frames/s [{card}]")
    test_idx = splits.flat("test")
    test01 = store.gather(np.asarray(test_idx)).astype(np.float32) / 255.0
    t = route_times(bundle, lambda: evaluate_consistency(
        bundle, test01, test_idx, meta.flags, num_trials=1,
        perturbations=(PERTURBATIONS[1],)))
    t_chunk = route_times(bundle, lambda: bundle.encode(eval_px[:128]))
    print(f"time: evaluation, one ({PERTURBATIONS[1]}, trial) of "
          f"evaluate_consistency on {len(test_idx)} test frames: graph "
          f"route {t['graph'] * 1e3:.2f} ms, eager {t['eager'] * 1e3:.2f} "
          f"ms; RBVAEBundle.encode of 128 uint8 frames: graph "
          f"{t_chunk['graph'] * 1e3:.3f} ms, eager "
          f"{t_chunk['eager'] * 1e3:.3f} ms [{card}]")
    t = route_times(tr, lambda: (tr.state_consistency(model, temps[2]),
                                 tr.state_separation(model, temps[2])))
    print(f"time: a probe (state_consistency + state_separation, "
          f"{len(val_idx)} val frames, bank route): graph route "
          f"{t['graph'] * 1e3:.2f} ms, eager {t['eager'] * 1e3:.2f} ms "
          f"[{card}]")
    for owner in (pipe, bundle, tr, probes["host"]):
        owner.drop_graphs()

    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--encode-capture-failure"], capture_output=True,
                          text=True, cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    require(proc.returncode == 0, f"encode capture failure check: exit "
            f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    failed = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"check an encode that reads the card on the host fails its "
          f"capture, in a process of its own: raised {failed['raised']!r}; "
          f"no graph: {failed['no_graph']}; launch counts as before the "
          f"call: {failed['launches_unchanged']}; no codes returned "
          f"(nothing encoded eagerly in its place) [{card}]")
    require(failed["raised"] and "capturing the encode" in failed["raised"]
            and "chip_smoke.py" in failed["raised"] and failed["no_graph"]
            and failed["launches_unchanged"],
            "a capture that fails must raise EncodeCaptureError naming the "
            "cause and encode nothing")
    print(f"graph route: phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def encode_capture_failure_worker() -> None:
    """``chip_smoke.py --encode-capture-failure``: the flagship pipeline on
    the card whose encode reads its codes on the host (``float``), as a
    graph's body must not. Its first call runs eagerly, where a read is
    allowed; its second must raise ``EncodeCaptureError`` naming the read,
    leave no graph, return no codes and leave the launch counts as they
    were. Prints one JSON line. In a process of its own: a capture that
    fails leaves the capture stream behind."""
    from svtpu_torch.models.encode_graph import EncodeCaptureError
    from svtpu_torch.ops.cuda_graph import Launches
    from svtpu_torch.pipeline import VideoSymbolPipeline

    pipe = VideoSymbolPipeline(*flagship(True))
    codes = pipe._codes

    def reads_on_host(*args):
        z = codes(*args)
        float(z.float().sum())
        return z
    pipe._codes = reads_on_host
    frames = np.random.default_rng(0).integers(0, 256, (64, 256, 256, 3),
                                               np.uint8)
    pipe.run_frames(frames, 0)
    launches = Launches()
    before = launches.read()
    raised = None
    try:
        pipe.run_frames(frames, 1)
    except EncodeCaptureError as e:
        raised = str(e)
    print(json.dumps({
        "raised": raised,
        "no_graph": all(k["captures"] == 0
                        for k in pipe._encode_graphs.report()),
        "launches_unchanged": all(n == 0 and not any(by.values())
                                  for n, by in launches.since(before))}))


class MemoryStore:
    """Frames in memory with ``FrameStore``'s interface (``array``,
    ``indices``, ``rows``, ``gather``, ``item_shape``, ``dtype``): row i
    holds frame id ``indices[i]``. The card's host may lack PIL, and the
    repo ships no frames."""

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


def train_video():
    """The segment frames of ``chinese_chess``'s geometry (5 states, flags
    74, 206, 282, 389, last frame 479, grey-out 10: 396 frames) as seeded
    256x256 RGB: a base colour per state plus noise. Returns the meta, the
    0.1/0.1 splits, the frame ids and the states of the frames."""
    from svtpu_torch.config import BUILTIN_VIDEOS
    from svtpu_torch.data.segments import assign_label, split_segments

    meta = BUILTIN_VIDEOS["chinese_chess"]
    splits = split_segments(meta.state_segments(), 0.1, 0.1)
    ids = sorted(splits.flat("train") + splits.flat("val")
                 + splits.flat("test"))
    states = np.asarray([assign_label(i, meta.flags) for i in ids])
    return meta, splits, ids, states


def video_frames(meta, states, hw=(256, 256), seed=11) -> np.ndarray:
    """``train_video()``'s frames as uint8 RGB of size ``hw``, seeded: a
    base colour per state plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 216, (meta.num_states, 1, 1, 3), np.uint8)
    return base[states] + rng.integers(0, 40, (len(states),) + tuple(hw)
                                       + (3,), np.uint8)


def card_cpu_step(mcfg, tcfg, batch: np.ndarray, seed: int,
                  dtype: str, params=None) -> dict:
    """One train step's loss and gradients on the card and on the CPU, in
    compute dtype ``dtype``, from the same parameters and injected uniforms
    (dropout off, TF32 off as ``main`` sets). The parameters: a fresh
    model's drawn from ``seed``, or ``params``, a ``svtpu`` tree (the
    trained flagship's)."""
    import dataclasses

    from svtpu_torch.models.convert import from_jax_params
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.training.trainer import (Noise, fold_lstm_biases,
                                              pair_objective)

    cfg = dataclasses.replace(mcfg, compute_dtype=dtype,
                              conv_dropout=0.0, pallas_trunk=False,
                              pallas_sampler=False)
    if params is None:
        sd = Seq2SeqBinaryVAE(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed)
                              ).state_dict()
    else:
        sd = from_jax_params(params, cfg)
    B, _, S = batch.shape[:3]
    rng = np.random.default_rng(seed)
    u = {0: rng.random((2 * B, S, cfg.latent_dim), np.float32),
         1: rng.random((2 * B * S, 1, cfg.latent_dim), np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        model = Seq2SeqBinaryVAE(cfg, device=dev)
        model.load_state_dict(sd)
        fold_lstm_biases(model)
        total, _ = pair_objective(
            model, tcfg, torch.from_numpy(batch).to(dev), 0.9, False,
            Noise(None, dev, {k: torch.from_numpy(v).to(dev)
                              for k, v in u.items()}), deterministic=False)
        total.backward()
        out[dev] = (float(total.detach()),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    return out


def phase_train_path(card: str) -> dict:
    """The training slice on the card: see the module docstring. Every
    check raises on failure."""
    import dataclasses

    from svtpu_torch.config import TrainConfig, rbvae_variant
    from svtpu_torch.data.datasets import EmbeddingStore
    from svtpu_torch.models.convert import load_params_npz
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.training.step_graph import WARMUP_STEPS, StepGraph
    from svtpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    meta, splits, ids, states = train_video()
    store = MemoryStore(video_frames(meta, states), ids)
    mcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16",
                         pallas_trunk=True, pallas_sampler=True)
    n_val = len(splits.flat("val"))
    chunks = -(-n_val // 128)
    B = FLAGSHIP_TRAIN["batch_size"]
    S = meta.num_states
    print(f"train path: synthetic {len(ids)} frames 256x256 at "
          f"chinese_chess's geometry ({S} states), train "
          f"{len(splits.flat('train'))} val {n_val} frames; made in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # Check 2: one step, card against CPU, the loss held to 1e-4 and each
    # gradient tensor to 1e-3 of its largest |grad|: from the trained
    # flagship's weights in f32; from a fresh model's in f64, its f32
    # gradients printed. A ReLU whose input rounds to the other side of 0
    # on one device drops that element's whole gradient, and at the init's
    # tiny decoder gradients that shows in f32 (PERF.md §6).
    tcfg = TrainConfig(**FLAGSHIP_TRAIN)
    trainer = Trainer(mcfg, tcfg, store, splits, meta.flags, device="cuda")
    rows = next(iter(trainer.train_batcher.epoch_indices(0)))[:2]
    trained = load_params_npz(ROOT / "results" / "p_hardened_params.npz")
    for dtype, params in (("float32", None), ("float64", None),
                          ("float32", trained)):
        steps = card_cpu_step(mcfg, tcfg, store.array[rows], 7, dtype,
                              params)
        (loss_cpu, g_cpu), (loss_card, g_card) = steps["cpu"], steps["cuda"]
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        errs = {n: float((g_card[n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for n, g in g_cpu.items()}
        worst = max(errs, key=errs.get)
        over = {n: f"{e:.2e}" for n, e in errs.items() if e > 1e-3}
        held = dtype == "float64" or params is not None
        print(f"check train step {dtype} from "
              f"{'the trained weights' if params else 'a fresh model'}, "
              f"card vs CPU ([2,2,{S},256,256,3], same parameters and "
              f"uniforms, dropout off): loss {loss_card:.8f} vs "
              f"{loss_cpu:.8f}, rel err {loss_rel:.2e} (limit 1e-4); worst "
              f"gradient err / its tensor's max |grad| {errs[worst]:.2e} "
              f"({worst}) over {len(g_cpu)} tensors; above 1e-3: "
              f"{over or 'none'} (limit 1e-3 "
              f"{'held' if held else 'printed'})")
        require(loss_rel <= 1e-4, f"train step {dtype}: card loss disagrees "
                "with the CPU")
        require(set(g_card) == set(g_cpu), "train step: gradient sets")
        if held:
            require(errs[worst] <= 1e-3, f"train step {dtype}: card "
                    "gradients disagree with the CPU")

    # The main path: 3 fused epochs, then the same 3 one step at a time,
    # deterministic algorithms on, the probes' kernel launches and the step
    # graphs counted.
    counters = {"fused_conv01": fused_conv01,
                "lstm_binary_concrete": lstm_binary_concrete,
                "binary_concrete": binary_concrete_fused}
    for fn in counters.values():
        fn.launches = 0
    StepGraph.captures = StepGraph.replays = 0
    hist, trainers, wall = {}, {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for fused in (True, False):
            tr = Trainer(mcfg, dataclasses.replace(
                tcfg, fused_epoch=fused, val_every=1), store, splits,
                meta.flags, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist[fused] = tr.train(num_epochs=TRAIN_EPOCHS)
            torch.cuda.synchronize()
            wall[fused] = time.perf_counter() - t0
            trainers[fused] = tr
    torch.use_deterministic_algorithms(False)
    launches = {k: fn.launches for k, fn in counters.items()}
    graphs = step_graph_counts()
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"train path: Trainer.train x{TRAIN_EPOCHS} epochs fused + "
          f"x{TRAIN_EPOCHS} per step (flagship preset, batch {B}, "
          f"{trainers[True].train_batcher.num_batches()} steps an epoch, "
          f"val_every 1), deterministic algorithms on: wall {wall[True]:.2f} "
          f"s fused, {wall[False]:.2f} s per step (first run includes "
          f"warm-up); probe launches {launches}; ops without a "
          f"deterministic implementation: {nondet or 'none'} [{card}]")

    # Check 1: finite losses, svtpu's metric names.
    for fused, h in hist.items():
        for e, (tl, vl) in enumerate(zip(h["train_losses"],
                                         h["val_losses"])):
            require(set(tl) == TRAIN_METRICS,
                    f"train metric names {sorted(tl)} (fused {fused})")
            require(all(np.isfinite(v) for v in list(tl.values())
                        + list(vl.values())),
                    f"non-finite metric, epoch {e} (fused {fused})")
    losses = [round(t["total_loss"], 4) for t in hist[True]["train_losses"]]
    scores = [round(v["combined_score"], 4)
              for v in hist[True]["val_losses"]]
    print(f"check train metrics: names {sorted(TRAIN_METRICS)}, all finite; "
          f"fused epochs' total_loss {losses}, combined_score {scores}")

    # Check 3: fused = per-step.
    pf = hist[True]["final_state"].model.state_dict()
    pu = hist[False]["final_state"].model.state_dict()
    param_err = max(float((pf[k].float() - pu[k].float()).abs().max())
                    for k in pf)
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(hist[True]["train_losses"],
                                   hist[False]["train_losses"])
                   for k in a)
    print(f"check fused epoch vs per-step loop after {TRAIN_EPOCHS} bf16 "
          f"epochs: max |param diff| {param_err:.3e} (limit 1e-6), max "
          f"per-epoch loss rel diff {loss_err:.3e}")
    if nondet:
        require(loss_err <= 1e-3, "fused vs per-step: losses disagree")
    else:
        require(param_err <= 1e-6, "fused vs per-step: parameters disagree")

    # Check 3b: every step of both runs went through the step graph: per
    # run one capture, and a replay for each step after the warm-up ones.
    steps = TRAIN_EPOCHS * trainers[True].train_batcher.num_batches()
    want_graphs = {"captures": 2, "replays": 2 * (steps - WARMUP_STEPS)}
    print(f"check the main path's train steps ran as CUDA graph replays: "
          f"{graphs} over 2 runs of {steps} steps ({WARMUP_STEPS} eager "
          f"warm-up steps a run; expected {want_graphs}); each run freed its "
          f"graph when it returned: "
          f"{all(h['final_state'].graph is None for h in hist.values())}")
    require(graphs == want_graphs and all(
        h["final_state"].graph is None for h in hist.values()),
        f"main path: step graphs {graphs}, expected {want_graphs}")

    # Check 4: the probes ran the kernels, and agree with the plain route.
    probed = sum(len([v for v in h["val_losses"] if v])
                 for h in hist.values())
    want = 2 * chunks * probed      # consistency + separation a probe
    require(launches["fused_conv01"] == want
            and launches["lstm_binary_concrete"] == want,
            f"probe launches {launches}, expected {want} of each kernel")
    tr = trainers[True]
    model = hist[True]["final_state"].model
    plain = Seq2SeqBinaryVAE(dataclasses.replace(
        mcfg, pallas_trunk=False, pallas_sampler=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    val_rows = store.rows(np.asarray(splits.flat("val")))
    codes = {name: tr.encode_frames(m, val_rows, 0.2, noise=False,
                                    from_bank=True)
             for name, m in (("kernel", model), ("plain", plain))}
    agree = float((codes["kernel"] == codes["plain"]).mean())
    print(f"check probe codes through the kernels vs the plain route "
          f"({n_val} val frames, deterministic): agreement {agree:.4f} "
          f"(limit 0.98); share of ones {codes['kernel'].mean():.3f}")
    require(agree >= 0.98, "probe codes: kernel route disagrees")

    # Check 5, and the epochs' wall time: a fused epoch's steps under
    # sync-debug "error", its upload and readback outside.
    state = hist[True]["final_state"]
    for _ in range(2):
        tr._fused_epoch(state, TRAIN_EPOCHS)   # warm-up steps, the capture
    fused_s = []
    for e in range(3):
        idx = tr._upload_epoch(TRAIN_EPOCHS + e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vec, _ = tr._fused_steps(state, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_s = time.perf_counter() - t0
        vec.cpu()
        fused_s.append(time.perf_counter() - t0)
    print(f"check no host synchronisation: {len(idx)} train steps of a fused "
          f"epoch ran under torch.cuda.set_sync_debug_mode('error') x3 and "
          f"raised nothing; the last returned to the host after "
          f"{host_s:.4f} s [{card}]")
    ustate, utr = hist[False]["final_state"], trainers[False]
    step_s = []
    for e in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        utr._per_step_epoch(ustate, TRAIN_EPOCHS + e)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(f"time: train epoch ({len(idx)} steps of batch {B}), fused "
          f"(upload, steps, one readback): {statistics.median(fused_s):.4f} "
          f"s median of 3 {[round(t, 4) for t in fused_s]}; per step "
          f"(prefetch, every step read back): "
          f"{statistics.median(step_s):.4f} s median of 3 "
          f"{[round(t, 4) for t in step_s]} [{card}]")

    # Probe time.
    probe_s = []
    for seed in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state_consistency(model, tcfg.final_temperature, seed=seed)
        tr.state_separation(model, tcfg.final_temperature)
        probe_s.append(time.perf_counter() - t0)
    print(f"time: probes (state_consistency + state_separation, {n_val} val "
          f"frames in {chunks} chunk(s) of 128 through both kernels): "
          f"{statistics.median(probe_s):.4f} s median of 3 [{card}]")

    # Check 6b: the pieces the step graph rests on. A replay picks up the
    # seeds set before it; the trainer's Adam (capturable) is optax's.
    seeds = replay_seeds()
    print(f"check a CUDA graph's draws from a persistent generator reseeded "
          f"before each replay: {seeds} (offset 0 and draws equal to a "
          f"fresh generator's, each seed) [{card}]")
    require(all(r["offset_before"] == 0 and r["draws_equal"] for r in seeds),
            "a replay did not pick up the generator's seed")
    adam_err = adam_against_optax(Trainer(mcfg, tcfg, store, splits,
                                          meta.flags, device="cuda"))
    print(f"check the trainer's Adam (capturable, on the card) against "
          f"optax's adam in float64 on the host, 2 steps on the flagship's "
          f"parameters with seeded gradients: max |param diff| "
          f"{adam_err:.3e} (limit 1e-5, tests/test_torch_objective.py's) "
          f"[{card}]")
    require(adam_err <= 1e-5, "capturable Adam disagrees with optax")

    # Check 7: the step graph against the eager route, bit for bit, from
    # the same state, across an anneal update and a raised floor; in bf16
    # and f32, remat off and on; then across a restart; then a step that
    # reads the card on the host must fail its capture.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f32 = dataclasses.replace(mcfg, compute_dtype="float32")
            for name, cfg in (
                    ("bf16", mcfg), ("f32", f32),
                    ("bf16, remat", dataclasses.replace(mcfg, remat=True)),
                    ("f32, remat", dataclasses.replace(f32, remat=True))):
                got = routes_agree(lambda cfg=cfg: Trainer(
                    cfg, tcfg, store, splits, meta.flags, device="cuda"))
                print(f"check graph route vs eager route, flagship {name}, "
                      f"{got['steps']} steps from the same state (2 epochs "
                      f"one step at a time, floor raised to {ROUTE_FLOOR}, "
                      f"a fused epoch under sync-debug 'error', 1 epoch one "
                      f"step at a time; epochs' mean temperature "
                      f"{got['temps']}): every metric and metric sum equal "
                      f"{got['metrics_equal']}, {got['tensors']} parameter "
                      f"and Adam tensors, differing {got['differ'] or 'none'}"
                      f"; step graphs graph route {got['graph']}, eager "
                      f"route {got['eager']}; capture "
                      f"{got['capture_s']:.3f} s [{card}]")
                require(got["equal"], f"graph route vs eager route ({name}): "
                        f"not bit for bit: {got['differ']}")
                require(got["graph"] == {"captures": 1, "replays":
                                         got["steps"] - WARMUP_STEPS}
                        and got["eager"] == {"captures": 0, "replays": 0},
                        f"graph route vs eager route ({name}): step graphs "
                        f"{got['graph']}, {got['eager']}")
            rcfg = dataclasses.replace(tcfg, restart_check_epoch=2,
                                       restart_min_sep=1e9, max_restarts=1,
                                       val_every=1)
            rh, rc = {}, {}
            for graphed in (True, False):
                rtr = Trainer(mcfg, rcfg, store, splits, meta.flags,
                              device="cuda")
                rtr._graphed = graphed
                c0 = step_graph_counts()
                rh[graphed] = rtr.train(num_epochs=4)
                rc[graphed] = {k: v - c0[k]
                               for k, v in step_graph_counts().items()}
    finally:
        torch.use_deterministic_algorithms(False)
    rbits = [train_state_bits(rh[g]["final_state"]) for g in (True, False)]
    rdiff = sorted(k for k in rbits[1] if not torch.equal(rbits[0][k],
                                                          rbits[1][k]))
    print(f"check graph route vs eager route across a restart: Trainer.train "
          f"4 epochs, restart after epoch 1 (restarts "
          f"{[len(h['restarts']) for h in rh.values()]}); step graphs graph "
          f"route {rc[True]}, eager route {rc[False]}; final parameters and "
          f"Adam state differing: {rdiff or 'none'} [{card}]")
    require(all(len(h["restarts"]) == 1 for h in rh.values())
            and rc[True]["captures"] == 2 and rc[False]["captures"] == 0
            and not rdiff, "graph route across a restart")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--capture-failure"], capture_output=True,
                          text=True, cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    require(proc.returncode == 0, f"capture failure check: exit "
            f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    failed = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"check a step that reads the card on the host (float(loss)) fails "
          f"its capture, in a process of its own: raised "
          f"{failed['raised']!r}; no graph: {failed['no_graph']}; parameters "
          f"and Adam state unchanged by the failed step (no eager step in "
          f"its place): {failed['unchanged']} [{card}]")
    require(failed["raised"] and "capturing the train step" in failed["raised"]
            and failed["no_graph"] and failed["unchanged"],
            "a capture that fails must raise StepCaptureError and train "
            "nothing")

    # Check 6: one epoch of percep-flagship on SD-shaped latents.
    emb = percep_latents(ids, states)
    pcfg = rbvae_variant("percep", LATENT, lstm_residual=True,
                         compute_dtype="bfloat16", pallas_sampler=True)
    for fn in counters.values():
        fn.launches = 0
    ptr = Trainer(pcfg, TrainConfig(**PERCEP_TRAIN), EmbeddingStore(emb),
                  splits, meta.flags, device="cuda")
    t0 = time.perf_counter()
    phist = ptr.train(num_epochs=1)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    p_launches = {k: fn.launches for k, fn in counters.items()}
    ptl, pvl = phist["train_losses"][0], phist["val_losses"][0]
    print(f"train path, percep-flagship: 1 epoch (batch "
          f"{PERCEP_TRAIN['batch_size']}, {ptr.train_batcher.num_batches()} "
          f"steps, [1,4,88,160] latents, 4-layer residual LSTM) in "
          f"{p_wall:.2f} s with its warm-up; total_loss "
          f"{ptl['total_loss']:.4f}, combined_score "
          f"{pvl['combined_score']:.4f}; probe launches {p_launches} [{card}]")
    require(all(np.isfinite(v) for v in list(ptl.values())
                + list(pvl.values())), "percep-flagship: non-finite metric")
    require(p_launches["lstm_binary_concrete"] == 2 * chunks,
            "percep-flagship probes did not run lstm_binary_concrete")
    print(f"train path: all checks passed in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "percep_launches": p_launches}


def chunks(n: int, chunk: int = 128) -> int:
    """Encode steps (``RBVAEBundle.encode``'s chunks) for ``n`` frames."""
    return -(-n // chunk)


def phase_eval_path(card: str) -> dict:
    """The evaluation slice on the card, through its entry points.

    The flagship (``results/p_hardened_params.npz``, bf16, both kernels) is
    saved by ``BestCheckpointer`` and read back by
    ``RBVAEBundle.from_checkpoint``, then evaluated on ``train_video()``'s
    396 frames: ``evaluate_consistency`` on the test split (three
    perturbations, 10 trials), ``evaluate_hamming`` on every frame,
    ``tradeoff.evaluate_checkpoint`` on the val split and
    ``codes_from_torch_checkpoint`` on the test split, each encode chunk
    one launch of ``fused_conv01`` and of ``lstm_binary_concrete``. Its
    noise-off codes and its noise-ratio-0 modal codes are held against a
    plain-route bundle. The percep model's consistency re-encodes its
    perturbed pixels through the SD first stage (``flash_attention``), and
    once more on perturbed latents (``perturb_embeddings``); the simple
    variant's encode runs the standalone ``binary_concrete``. Each run's
    launches are counted from 0 and must be exact."""
    import functools
    import tempfile

    from svtpu_torch.config import PerceptualConfig, rbvae_variant
    from svtpu_torch.evaluation import bitmatch, tradeoff
    from svtpu_torch.evaluation.common import RBVAEBundle
    from svtpu_torch.evaluation.consistency import (PERTURBATIONS,
                                                    evaluate_consistency,
                                                    perturb_embeddings)
    from svtpu_torch.evaluation.hamming import evaluate_hamming
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.training.checkpoints import BestCheckpointer

    counters = {"fused_conv01": fused_conv01,
                "lstm_binary_concrete": lstm_binary_concrete,
                "binary_concrete": binary_concrete_fused,
                "flash_attention": flash_attention}

    def counted(run):
        """``run()``'s result, the wall seconds to its codes on the host,
        and the launches it made, every count set to 0 before it."""
        for fn in counters.values():
            fn.launches = 0
        for name in flash_attention.launches_by_kernel:
            flash_attention.launches_by_kernel[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k: fn.launches for k, fn in counters.items()}

    def median_s(run, n: int = 5) -> float:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    t_phase = time.perf_counter()
    meta, splits, ids, states = train_video()
    store = MemoryStore(video_frames(meta, states), ids)
    test_idx, val_idx = splits.flat("test"), splits.flat("val")
    test01 = store.gather(np.asarray(test_idx)).astype(np.float32) / 255.0
    frames = store.gather(np.asarray(ids))
    flags = meta.flags

    # The flagship through a checkpoint written as the trainer writes it.
    cfg, sd = flagship(True)
    with tempfile.TemporaryDirectory() as d:
        BestCheckpointer(d).save({"model": sd, "optimizer": {}}, epoch=0,
                                 metric=0.0)
        bundle = RBVAEBundle.from_checkpoint(d, cfg, name="flagship",
                                             device="cuda")
    got = bundle.model.state_dict()
    require(set(got) == set(sd) and all(torch.equal(got[k].cpu(), v)
                                        for k, v in sd.items()),
            "eval: the checkpoint did not round-trip exactly")

    def flagship_eval():
        return (evaluate_consistency(bundle, test01, test_idx, flags),
                evaluate_hamming(bundle, frames, ids, flags),
                tradeoff.evaluate_checkpoint(bundle, store.gather(
                    np.asarray(val_idx)), val_idx, flags),
                bitmatch.codes_from_torch_checkpoint(sd, cfg, test01,
                                                     device="cuda"))

    (cons, ham, point, ported), wall, launches = counted(flagship_eval)
    trials = len(cons[0].trials)
    want = (len(PERTURBATIONS) * trials * chunks(len(test_idx))
            + chunks(len(ids)) + 2 * chunks(len(val_idx))
            + chunks(len(test_idx)))
    print(f"eval path, flagship: evaluate_consistency ({len(test_idx)} test "
          f"frames, {len(PERTURBATIONS)} perturbations x {trials} trials) + "
          f"evaluate_hamming ({len(ids)} frames, {chunks(len(ids))} chunks, "
          f"the last padded) + tradeoff.evaluate_checkpoint ({len(val_idx)} "
          f"val frames) + codes_from_torch_checkpoint ({len(test_idx)} test "
          f"frames) in {wall:.2f} s with its warm-up; launches {launches}, "
          f"expected {want} of fused_conv01 and lstm_binary_concrete, 0 of "
          f"binary_concrete [{card}]")
    require(launches["fused_conv01"] == want
            and launches["lstm_binary_concrete"] == want
            and launches["binary_concrete"] == 0
            and launches["flash_attention"] == 0,
            f"eval flagship launches {launches}, expected {want}")
    scores = [s for r in cons for s in r.trials] + [point[0], point[2]]
    require(all(np.isfinite(s) and 0.0 <= s <= 1.0 for s in scores),
            f"eval: a consistency score outside [0, 1]: {scores}")
    require(np.isfinite(point[1]) and 0.0 <= point[1] <= LATENT
            and ham["hamming"].shape == (meta.num_states - 1,)
            and ham["modal_codes"].shape == (meta.num_states, LATENT),
            "eval: separation or Hamming result")
    require(ported.shape == (len(test_idx), LATENT)
            and set(np.unique(ported)) <= {0.0, 1.0}, "eval: ported codes")
    print("eval path, flagship: consistency "
          + ", ".join(f"{r.perturbation} {r.mean:.4f} (std {r.std:.4f})"
                      for r in cons)
          + f"; Hamming {ham['hamming'].tolist()}; trade-off point "
          f"(consistency, separation, det consistency) "
          f"{tuple(round(v, 4) for v in point)}")

    # The kernel route against the plain route on the same weights.
    plain = RBVAEBundle(*flagship(False), name="plain", device="cuda")
    match = bitmatch.bit_match(bundle.encode(frames, noise=False),
                               plain.encode(frames, noise=False))
    modal = {}
    for dtype, pair in (("bf16", (bundle, plain)),
                        ("f32", tuple(RBVAEBundle(*flagship(k, "float32"),
                                                  device="cuda")
                                      for k in (True, False)))):
        m = [evaluate_hamming(b, frames, ids, flags, noise_ratio=0.0)
             ["modal_codes"] for b in pair]
        modal[dtype] = int((m[0] != m[1]).sum())
    n_modal = meta.num_states * LATENT
    print(f"check eval codes, kernel route vs plain route: noise off on "
          f"{len(ids)} frames, bit_match {match['bit_match_pct']:.4f}% "
          f"(limit 98% bf16), exact codes "
          f"{match['exact_code_match_pct']:.2f}%; evaluate_hamming at noise "
          f"ratio 0, modal code bits that differ of {n_modal}: bf16 "
          f"{modal['bf16']} (limit {int(0.02 * n_modal)}), f32 {modal['f32']} "
          f"(limit 0)")
    require(match["bit_match_pct"] >= 98.0, "eval codes: kernel route "
            "disagrees with the plain route")
    require(modal["bf16"] <= 0.02 * n_modal and modal["f32"] == 0,
            "eval modal codes: kernel route disagrees with the plain route")

    trial_s = {k: median_s(lambda k=k: evaluate_consistency(
        bundle, test01, test_idx, flags, num_trials=1, perturbations=(k,)))
        for k in PERTURBATIONS}
    ham_s = median_s(lambda: evaluate_hamming(bundle, frames, ids, flags))
    print(f"time: eval, flagship, one (perturbation, trial) of "
          f"evaluate_consistency on {len(test_idx)} test frames, host clock "
          f"to codes on the host, median of 5: "
          + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in trial_s.items())
          + f"; evaluate_hamming on {len(ids)} frames: {ham_s * 1e3:.2f} ms "
          f"[{card}]")

    # The percep model: perturbed pixels back through the SD first stage.
    pframes = np.random.default_rng(8).integers(
        0, 256, (PERCEP_FRAMES, 704, 1280, 3), np.uint8)
    weights = percep_weights(pframes[:2])
    enc = PerceptualEncoder(weights["ae"],
                            PerceptualConfig(compute_dtype="bfloat16"),
                            batch_size=PERCEP_BATCH, use_kernel=True)
    pbundle = RBVAEBundle(percep_rbvae_cfg(True), weights["rbvae"],
                          name="percep", device="cuda")
    plabels = np.repeat(np.arange(4), PERCEP_FRAMES // 4)
    pidx = list(range(PERCEP_FRAMES))
    p01 = pframes.astype(np.float32) / 255.0

    def pixel_to_input(frames01, seed):
        enc.seed = seed
        return enc.encode_frames(
            np.clip(frames01 * 255.0, 0, 255).astype(np.uint8))

    def percep_eval(kinds=PERTURBATIONS):
        return evaluate_consistency(pbundle, p01, pidx, [], num_trials=1,
                                    perturbations=kinds,
                                    pixel_to_input=pixel_to_input,
                                    labels=plabels)

    pcons, pwall, plaunch = counted(percep_eval)
    by_kernel = dict(flash_attention.launches_by_kernel)
    pwant = {"flash_attention": len(PERTURBATIONS) * chunks(
        PERCEP_FRAMES, PERCEP_BATCH),
        "lstm_binary_concrete": len(PERTURBATIONS),
        "binary_concrete": 0, "fused_conv01": 0}
    enc.seed = 0
    latents = enc.encode_frames(pframes)
    ecodes, ewall, elaunch = counted(lambda: evaluate_consistency(
        pbundle, latents, pidx, [], num_trials=1, labels=plabels,
        perturb_fn=functools.partial(perturb_embeddings, device="cuda")))
    ewant = dict(pwant, flash_attention=0)
    ptrial_s = {k: median_s(lambda k=k: percep_eval((k,)), 2)
                for k in PERTURBATIONS}
    print(f"eval path, percep: evaluate_consistency ({PERCEP_FRAMES} "
          f"frames 1280x704, pixel_to_input = encode_frames in batches of "
          f"{PERCEP_BATCH}, {len(PERTURBATIONS)} perturbations x 1 trial) in "
          f"{pwall:.2f} s: launches {plaunch}, flash_attention by kernel "
          f"{by_kernel}, expected {pwant}; consistency "
          + ", ".join(f"{r.perturbation} {r.mean:.4f}" for r in pcons)
          + f"; on perturb_embeddings' latents in {ewall:.2f} s: launches "
          f"{elaunch}, expected {ewant}; consistency "
          + ", ".join(f"{r.perturbation} {r.mean:.4f}" for r in ecodes)
          + f" [{card}]")
    print(f"time: eval, percep, one (perturbation, trial) of "
          f"evaluate_consistency with the SD re-encode, host clock, median "
          f"of 2: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                for k, v in ptrial_s.items())
          + f" [{card}]")
    require(plaunch == pwant and by_kernel["bf16_d512"] == pwant[
        "flash_attention"], f"eval percep launches {plaunch}")
    require(elaunch == ewant, f"eval percep (embeddings) launches {elaunch}")
    require(all(np.isfinite(s) and 0.0 <= s <= 1.0
                for r in pcons + ecodes for s in r.trials),
            "eval percep: a consistency score outside [0, 1]")

    # The simple variant: binarizes before its LSTM, so the standalone
    # sampler kernel, reached from the bundle's encode.
    scfg = rbvae_variant("simple", LATENT, compute_dtype="bfloat16",
                         pallas_sampler=True)
    ssd = Seq2SeqBinaryVAE(scfg, device="cpu",
                           generator=torch.Generator().manual_seed(22)
                           ).state_dict()
    sframes = np.random.default_rng(3).integers(0, 256, (BATCH, 64, 64, 3),
                                                np.uint8)
    sbundle = RBVAEBundle(scfg, ssd, name="simple", device="cuda")
    scodes, _, slaunch = counted(lambda: sbundle.encode(sframes))
    swant = {"binary_concrete": chunks(BATCH), "lstm_binary_concrete": 0,
             "fused_conv01": 0, "flash_attention": 0}
    print(f"eval path, simple: RBVAEBundle.encode ({BATCH} frames 64x64, "
          f"noise on): launches {slaunch}, expected {swant}; share of ones "
          f"{scodes.mean():.3f}")
    require(slaunch == swant, f"eval simple launches {slaunch}")
    require(scodes.shape == (BATCH, LATENT), "eval simple codes")
    print(f"eval path: all checks passed in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"flagship": launches, "percep": plaunch,
            "percep embeddings": elaunch, "simple": slaunch}


def percep_latents(ids, states) -> dict:
    """Seeded SD-shaped latents for ``train_video()``'s frames in the
    reference's ``.npy`` layout, ``{"%010d.jpg": float32 [1, 4, 88, 160]}``:
    unit noise plus half the frame's state."""
    prng = np.random.default_rng(12)
    return {f"{i:010d}.jpg": (prng.normal(size=(1, 4, 88, 160))
                              + 0.5 * s).astype(np.float32)
            for i, s in zip(ids, states)}


def write_jpegs(d: Path, frames: np.ndarray, ids=None) -> None:
    """``frames[k]`` as ``d / "%010d.jpg" % ids[k]`` (``ids``: 0, 1, ...
    by default; PIL, its default quality)."""
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    for i, f in zip(range(len(frames)) if ids is None else ids, frames):
        Image.fromarray(f).save(d / f"{i:010d}.jpg")


def sweep_argv(frames_dir: Path, save_dir: Path) -> list:
    """The CLI's ``sweep`` as a user runs it on ``train_video()``'s JPEGs:
    2 trials of the ``contrastive_p`` space, 2 epochs each (the space's
    300 cut), the seeded local search (no W&B)."""
    return ["sweep", "--video", "chinese_chess", "--frames-dir",
            str(frames_dir), "--variant", "contrastive_p", "--count", "2",
            "--epochs", "2", "--no-wandb", "--seed", "0", "--save-dir",
            str(save_dir)]


def sd_consistency_argv(sd_dir: Path, sd_ckpt: Path, pckpt: Path,
                        out: Path) -> list:
    """``eval-consistency --variant percep --sd-ckpt`` of a percep-flagship
    checkpoint on the ``PERCEP_FRAMES`` SD-sized JPEGs of ``sd_dir``, every
    frame a test frame, 1 trial (the flags
    ``tests/_torch_cli_rank.py::consistency_argv`` passes on the CPU)."""
    return ["eval-consistency", "--video", "sd16", "--flags",
            PERCEP_FRAMES // 2, "--last-frame", PERCEP_FRAMES - 1,
            "--grey-out", 0, "--test-pct", 1.0, "--val-pct", 0.0,
            "--frames-dir", sd_dir, "--variant", "percep", "--sd-ckpt",
            sd_ckpt, "--ckpt", pckpt, "--latent-dim", LATENT,
            "--lstm-residual", "--trials", 1, "--out-dir", out]


# 3 perturbations x 1 trial x the SD batches of ``PERCEP_FRAMES`` frames,
# each one encoder attention (on every rank: each encodes its rows).
SD_CONSISTENCY_LAUNCHES = 3 * chunks(PERCEP_FRAMES, PERCEP_BATCH)


def phase_cli_path(card: str) -> dict:
    """The command line (``svtpu_torch.cli.main``) on the card, in-process so
    that the wrappers' launch counters can be read, every command without
    ``--device`` (the card is the default). The card's host has PIL (PERF.md
    §6), so the phase requires it and drives the commands that read images
    too:

      * on 396 seeded latents at ``chinese_chess``'s geometry: ``train
        --preset percep-flagship`` (1 epoch), then ``eval-hamming``,
        ``eval-consistency`` (embedding protocol, 2 trials) and
        ``eval-tradeoff --extra`` on its checkpoint; ``eval-hamming`` also as
        ``python3 -m svtpu_torch.cli`` in a subprocess, whose output must
        equal the in-process run's;
      * on the 480 frames of a seeded 256x256 video of that geometry as
        JPEGs: ``train --preset flagship`` (2 epochs), ``encode`` of the
        directory (noisy, then ``--deterministic``, held bit for bit against
        ``VideoSymbolPipeline.run_frames``), ``eval-hamming`` and
        ``eval-consistency --trials 2``;
      * on 16 seeded 720x1280 JPEGs, with ``percep_weights`` saved by
        ``torch.save`` under ``first_stage_model.`` names: ``embed`` and
        ``embed --deterministic`` (held against
        ``PerceptualEncoder.encode_frames``), and ``eval-consistency
        --variant percep --sd-ckpt`` (1 trial).

    The CLI keeps ``svtpu``'s defaults, ``pallas_trunk`` and
    ``pallas_sampler`` off, so only ``flash_attention`` (the SD first
    stage's) lies on its path: its launches must be exact, every other
    kernel's 0. The commands run under PyTorch's default TF32 settings, as
    a user's do. Each command's wall time (host clock) is printed."""
    import contextlib
    import io
    import tempfile

    from svtpu_torch import cli
    from svtpu_torch.config import BUILTIN_VIDEOS, PerceptualConfig
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.data.datasets import FrameStore
    from svtpu_torch.data.segments import assign_label
    from svtpu_torch.data.symbols import SymbolStore
    from svtpu_torch.evaluation.common import RBVAEBundle
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.perceptual.convert import PREFIX
    from svtpu_torch.perceptual.embed import (PerceptualEncoder,
                                              load_frame_pm1)
    from svtpu_torch.pipeline import VideoSymbolPipeline
    from svtpu_torch.training.checkpoints import BestCheckpointer

    require(importlib.util.find_spec("PIL") is not None,
            "cli path: PIL is missing on the card's host")
    counters = {"fused_conv01": fused_conv01,
                "lstm_binary_concrete": lstm_binary_concrete,
                "binary_concrete": binary_concrete_fused,
                "flash_attention": flash_attention}
    total = dict.fromkeys(counters, 0)
    none = dict.fromkeys(counters, 0)

    def run(argv, want=none, peak_min=1):
        """``cli.main(argv)`` with every count set to 0 before it: its
        stdout, and the wall seconds. Launches must equal ``want``, and
        the card memory the command allocated must reach ``peak_min``
        bytes (its model's weights: it ran on the card)."""
        for fn in counters.values():
            fn.launches = 0
        for name in flash_attention.launches_by_kernel:
            flash_attention.launches_by_kernel[name] = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        got = {k: fn.launches for k, fn in counters.items()}
        for k, v in got.items():
            total[k] += v
        out = buf.getvalue()
        last = [ln for ln in out.splitlines() if ln][-3:]
        shown = " ".join(a.name if isinstance(a, Path) else str(a)
                         for a in argv)
        print(f"cli {shown}: "
              f"{wall:.2f} s, launches {got}, card memory allocated "
              f"{peak / 2 ** 20:.1f} MiB; last output {last} [{card}]")
        require(got == dict(none, **want), f"cli {argv[0]}: launches {got}, "
                f"expected {dict(none, **want)}")
        require(peak >= peak_min, f"cli {argv[0]}: allocated {peak} bytes on "
                f"the card, expected at least {peak_min} (its weights)")
        return out, wall

    def csv_rows(path):
        return Path(path).read_text().strip().splitlines()

    def weight_bytes(ckpt):
        tree, _ = BestCheckpointer(ckpt).restore()
        return sum(v.numel() * v.element_size()
                   for v in tree["model"].values())

    def card_bundle(ckpt, cfg):
        b = RBVAEBundle.from_checkpoint(ckpt, cfg, device="cuda")
        require(all(p.device.type == "cuda" for p in b.model.parameters()),
                "cli: a checkpoint's bundle is not on the card")
        return b

    t_phase = time.perf_counter()
    saved_tf32 = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True           # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    meta, splits, ids, states = train_video()
    video = ["--video", "chinese_chess"]
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # 1. The percep-flagship on latents: no image file read.
        np.save(d / "latents.npy", percep_latents(ids, states))
        pckpt, pdata = d / "percep_ckpt", ["--embeddings", d / "latents.npy"]
        run(["train", "--preset", "percep-flagship", *video, *pdata,
             "--epochs", 1, "--save-path", pckpt])
        pbytes = weight_bytes(pckpt)
        card_bundle(pckpt, rbvae_variant("percep", LATENT,
                                         lstm_residual=True))
        pmodel = ["--variant", "percep", "--latent-dim", LATENT,
                  "--lstm-residual", "--ckpt", pckpt, *pdata]
        ham_argv = ["eval-hamming", *video, *pmodel, "--out-dir",
                    d / "ham_in"]
        ham_out, _ = run(ham_argv, peak_min=pbytes)
        require(len(csv_rows(d / "ham_in" / "hamming.csv"))
                == meta.num_states, "cli eval-hamming: CSV rows")
        run(["eval-consistency", *video, *pmodel, "--trials", 2,
             "--out-dir", d / "cons_p"], peak_min=pbytes)
        require(len(csv_rows(d / "cons_p" / "consistency.csv")) == 4,
                "cli eval-consistency (embeddings): CSV rows")
        run(["eval-tradeoff", *video, *pdata, "--variant", "percep",
             "--extra", f"percep:{pckpt}:{LATENT}", "--out-dir",
             d / "trade"], peak_min=pbytes)
        require(len(csv_rows(d / "trade" / "tradeoff.csv")) == 2,
                "cli eval-tradeoff: CSV rows")
        # The same eval-hamming as a user runs it: a fresh interpreter, no
        # --device.
        sub_argv = [str(a) for a in ham_argv[:-1]] + [str(d / "ham_sub")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "svtpu_torch.cli",
                               *sub_argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        sub_wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"cli subprocess failed: "
                f"{proc.stderr[-2000:]}")

        def hamming_lines(out):
            return [ln for ln in out.splitlines() if "adjacent hamming" in ln]

        same = (hamming_lines(proc.stdout) == hamming_lines(ham_out)
                and csv_rows(d / "ham_sub" / "hamming.csv")
                == csv_rows(d / "ham_in" / "hamming.csv"))
        print(f"cli subprocess: python3 -m svtpu_torch.cli eval-hamming, no "
              f"--device, {sub_wall:.2f} s with its start-up; output "
              f"{hamming_lines(proc.stdout)}, equal to the in-process run's "
              f"and its CSV: {same} [{card}]")
        require(same, "cli subprocess: output differs from the in-process "
                "run's")

        # 2. The flagship on a JPEG directory.
        frames_dir = d / "frames"
        all_ids = np.arange(meta.last_frame + 1)
        all_states = np.asarray([assign_label(i, meta.flags)
                                 for i in all_ids])
        t0 = time.perf_counter()
        write_jpegs(frames_dir, video_frames(meta, all_states))
        n_all = len(all_ids)
        print(f"cli path: wrote {n_all} seeded 256x256 JPEGs "
              f"(chinese_chess's geometry; its segments hold {len(ids)}) in "
              f"{time.perf_counter() - t0:.1f} s")
        fckpt = d / "flagship_ckpt"
        fdata = [*video, "--frames-dir", frames_dir]
        run(["train", "--preset", "flagship", *fdata, "--epochs", 2,
             "--save-path", fckpt])
        fbytes = weight_bytes(fckpt)
        fcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16")
        card_bundle(fckpt, fcfg)
        enc = ["encode", frames_dir, "--ckpt", fckpt, *video]
        run([*enc, "--out", d / "sym_warm.npz"], peak_min=fbytes)
        _, enc_wall = run([*enc, "--out", d / "sym.npz"], peak_min=fbytes)
        run([*enc, "--deterministic", "--out", d / "sym_det.npz"],
            peak_min=fbytes)
        sym, det = (SymbolStore.load(d / n) for n in ("sym.npz",
                                                        "sym_det.npz"))
        for s in (sym, det):
            require(len(s) == n_all and s.codes.shape == (n_all, LATENT)
                    and set(np.unique(s.codes)) <= {0, 1}
                    and np.array_equal(s.labels, all_states),
                    "cli encode: SymbolStore shape, values or labels")
        # The library path on the same frames and checkpoint.
        t0 = time.perf_counter()
        store = FrameStore(frames_dir, all_ids, resolution=(256, 256))
        decode_s = time.perf_counter() - t0
        tree, _ = BestCheckpointer(fckpt).restore()
        pipes = {noise: VideoSymbolPipeline(fcfg, tree["model"], noise=noise)
                 for noise in (False, True)}

        def library(noise):
            return np.concatenate([pipes[noise].run_frames(
                store.array[i:i + 64], batch_index=i)
                for i in range(0, n_all, 64)])

        lib_det = library(False)
        require(np.array_equal(det.codes, lib_det), "cli encode "
                "--deterministic differs from VideoSymbolPipeline.run_frames")
        require(np.array_equal(sym.codes, library(True)), "cli encode "
                "(noisy) differs from run_frames with the same batch seeds")
        enc_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            library(True)
            enc_s.append(time.perf_counter() - t0)
        enc_s = statistics.median(enc_s)
        print(f"check cli encode: {n_all} codes of dim {LATENT} in {{0, 1}} "
              f"with their labels; --deterministic equals "
              f"VideoSymbolPipeline.run_frames bit for bit, and the noisy "
              f"run equals it with the same batch seeds; share of ones "
              f"{sym.codes.mean():.3f}")
        print(f"time: cli encode, {n_all} 256x256 JPEGs -> SymbolStore on "
              f"disk, noisy, batch 64, bf16, in-process after one warm-up "
              f"run: {enc_wall:.3f} s, {n_all / enc_wall:.1f} frames/s end "
              f"to end; of which JPEG decode (FrameStore, 16 threads) "
              f"{decode_s:.3f} s ({n_all / decode_s:.1f} frames/s), card "
              f"encode (run_frames x{-(-n_all // 64)}, median of 3) "
              f"{enc_s:.3f} s ({n_all / enc_s:.1f} frames/s) [{card}]")
        fmodel = ["--ckpt", fckpt, "--latent-dim", LATENT]
        run(["eval-hamming", *fdata, *fmodel, "--out-dir", d / "ham_f"],
            peak_min=fbytes)
        require(len(csv_rows(d / "ham_f" / "hamming.csv"))
                == meta.num_states, "cli eval-hamming (pixels): CSV rows")
        run(["eval-consistency", *fdata, *fmodel, "--trials", 2,
             "--out-dir", d / "cons_f"], peak_min=fbytes)
        require(len(csv_rows(d / "cons_f" / "consistency.csv")) == 4,
                "cli eval-consistency (pixels): CSV rows")

        # 3. The SD first stage on 720x1280 JPEGs.
        sd_dir = d / "sd_frames"
        write_jpegs(sd_dir, np.random.default_rng(9).integers(
            0, 256, (PERCEP_FRAMES, 720, 1280, 3), np.uint8))
        pcfg = PerceptualConfig()
        paths = sorted(sd_dir.glob("*.jpg"))
        decoded = np.stack([load_frame_pm1(str(p), pcfg.resize_wh)
                            for p in paths])
        weights = percep_weights(decoded[:2])
        torch.save({"state_dict": {PREFIX + k: v.cpu()
                                   for k, v in weights["ae"].items()}},
                   d / "sd.ckpt")
        ae_bytes = sum(v.numel() * v.element_size()
                       for v in weights["ae"].values())
        attn = {"flash_attention": chunks(PERCEP_FRAMES, PERCEP_BATCH)}
        for det_flag in ([], ["--deterministic"]):
            run(["embed", sd_dir, d / "emb.npy", "--ckpt", d / "sd.ckpt",
                 *det_flag], attn, peak_min=ae_bytes)
            require(flash_attention.launches_by_kernel["bf16_d512"]
                    == attn["flash_attention"],
                    "cli embed: attention not on the D = 512 kernel")
        emb = np.load(d / "emb.npy", allow_pickle=True).item()
        require(sorted(emb) == [p.name for p in paths] and all(
            v.shape == (1, 4, 88, 160) and v.dtype == np.float32
            for v in emb.values()), "cli embed: keys or shapes")
        ref = PerceptualEncoder(weights["ae"], pcfg, stochastic=False,
                                device="cuda").encode_frames(decoded)
        got = np.concatenate([emb[p.name] for p in paths]).transpose(
            0, 2, 3, 1)
        err = float(np.abs(got - ref).max())
        print(f"check cli embed --deterministic vs "
              f"PerceptualEncoder.encode_frames on the same decoded frames: "
              f"max abs diff {err} (limit 0: the same code on the same "
              f"card)")
        require(err == 0.0, "cli embed differs from encode_frames")
        sd_want = {"flash_attention": SD_CONSISTENCY_LAUNCHES}
        run(sd_consistency_argv(sd_dir, d / "sd.ckpt", pckpt,
                                d / "cons_sd"), sd_want, peak_min=ae_bytes)
        require(flash_attention.launches_by_kernel["bf16_d512"]
                == sd_want["flash_attention"],
                "cli eval-consistency --sd-ckpt: attention not on the D = "
                "512 kernel")
        require(len(csv_rows(d / "cons_sd" / "consistency.csv")) == 4,
                "cli eval-consistency --sd-ckpt: CSV rows")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved_tf32
    print(f"cli path: all checks passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {total} "
          f"(flash_attention: 2 embeds x {attn['flash_attention']} + "
          f"{sd_want['flash_attention']}; the rest 0: the CLI keeps svtpu's "
          f"kernel defaults) [{card}]")
    return {"launches": total, "encode_fps": n_all / enc_wall}


def write_video(path: Path, frames: np.ndarray, fps: float = 30.0) -> None:
    """``frames`` as an MJPG AVI, written by cv2."""
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
    require(writer.isOpened(), "video path: cv2 cannot write MJPG AVI")
    for f in frames:
        writer.write(f)
    writer.release()


def padded_batches(frames: np.ndarray, batch: int) -> list:
    """``run_video``'s batches of decoded frames: the last padded with
    copies of its last frame."""
    out = []
    for i in range(0, len(frames), batch):
        b = frames[i:i + batch]
        out.append(np.concatenate([b, np.repeat(b[-1:], batch - len(b), 0)]))
    return out


def host_libraries() -> str:
    """What the card's host has for the native IO library: g++, and the
    libav / libjpeg headers and shared libraries (found or not)."""
    import glob
    import shutil

    def found(pattern):
        return bool(glob.glob(pattern, recursive=True))

    heads = {h: found(f"/usr/include/**/{h}") or found(
        f"/usr/local/include/**/{h}")
        for h in ("libavcodec/avcodec.h", "libavformat/avformat.h",
                  "libswscale/swscale.h", "jpeglib.h")}
    libs = {lib: found(f"/usr/lib/**/lib{lib}.so*") or found(
        f"/usr/local/lib/**/lib{lib}.so*")
        for lib in ("avcodec", "avformat", "avutil", "swscale", "jpeg")}
    return (f"g++ {shutil.which('g++')}, headers {heads}, shared libraries "
            f"{libs}")


def phase_video_path(card: str) -> dict:
    """The video slice on the card.

      * ``VideoSymbolPipeline.run_video`` of the flagship (both kernels,
        bf16, batch 64) on a seeded MJPG AVI of 480 frames at 432x768
        written by cv2, decoded by cv2 (the card's host cannot build the
        native library: the phase prints its host line), noisy, with
        ``noise=False`` and with ``limit=100``; launches exact (8
        ``fused_conv01`` and 8 ``lstm_binary_concrete`` a run, 2 each
        for the limit); the codes equal ``run_frames`` on the same decoded
        batches bit for bit, the noisy ones with ``batch_index`` the batch
        ordinal; a missing file raises ``OSError`` within 10 s; the CLI's
        ``encode <video.avi>`` writes 480 codes, equal to the plain route's
        ``run_frames`` with the same seeds;
      * the int8 trunk at B = 512 (its int32 accumulators equal the plain
        version's exactly; its codes against the bf16 plain route's, on 512
        seeded frames and on the evaluation cell's 396); conv0 by
        space-to-depth against cuDNN's direct conv at B = 512; the decoder by
        depth-to-space against ``conv_transpose2d`` at the flagship train
        shape, forward and backward;
      * ``train --preset multi-video --multi a=... --multi b=...`` (2
        epochs) on two seeded 256x256 JPEG videos of ``chinese_chess``'s
        geometry, its frame bank on the card as one tensor, then
        ``eval-hamming --multi`` (10 global states, 9 adjacent pairs) and
        ``eval-consistency --multi --trials 2``.

    Every time is printed beside the card's name and power limit."""
    import contextlib
    import io
    import tempfile
    import threading

    import svtpu_torch.training.trainer as trainer_mod
    from svtpu_torch import cli
    from svtpu_torch.data.frames import iter_frames_cv2, video_info
    from svtpu_torch.data.segments import assign_label
    from svtpu_torch.data.symbols import SymbolStore
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.pipeline import VideoSymbolPipeline
    from svtpu_torch.training.checkpoints import BestCheckpointer

    t_phase = time.perf_counter()
    counters = {"fused_conv01": fused_conv01,
                "lstm_binary_concrete": lstm_binary_concrete,
                "binary_concrete": binary_concrete_fused,
                "flash_attention": flash_attention}
    total = dict.fromkeys(counters, 0)

    def counted(fn, want, what):
        """``fn()`` with every count set to 0 before it; its launches must
        equal ``want`` (the others 0). Returns its result and wall s."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        for k, v in got.items():
            total[k] += v
        want = dict(dict.fromkeys(counters, 0), **want)
        print(f"video path: {what}: {wall:.3f} s, launches {got} [{card}]")
        require(got == want, f"video path: {what}: launches {got}, "
                f"expected {want}")
        return out, wall

    print(f"video path: the card's host for the native IO library: "
          f"{host_libraries()}")
    print("video path: native IO library: not built on this host (it has "
          "no libav / libjpeg to link): run_video decodes with cv2 and "
          "FrameStore with PIL here; the native reader's and decoder's card "
          "run waits for those libraries (ROADMAP §A.4); their cases run "
          "in the CPU tests")
    from svtpu_torch.data import native

    require(importlib.util.find_spec("cv2") is not None,
            "video path: cv2 is missing on the card's host")
    require(not native.available(), "video path: a native IO library is "
            "built here; this phase is written for cv2 decode")
    meta = train_video()[0]
    n_all = meta.last_frame + 1
    all_states = np.asarray([assign_label(i, meta.flags)
                             for i in range(n_all)])
    cfg, sd = flagship(True)
    per_run = -(-n_all // VIDEO_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        video = d / "chinese_chess.avi"
        t0 = time.perf_counter()
        # Noise in 2x2 blocks: a quarter of the draws, and an MJPG stream
        # nearer a camera's than per-pixel noise.
        half = (VIDEO_HW[0] // 2, VIDEO_HW[1] // 2)
        write_video(video, video_frames(meta, all_states, half, seed=21)
                    .repeat(2, axis=1).repeat(2, axis=2))
        info = video_info(video)
        print(f"video path: wrote {n_all} seeded {VIDEO_HW[0]}x{VIDEO_HW[1]} "
              f"frames as MJPG AVI ({video.stat().st_size / 2 ** 20:.1f} "
              f"MiB) in {time.perf_counter() - t0:.2f} s; cv2 reads {info}")
        require(info["frames"] == n_all
                and (info["height"], info["width"]) == VIDEO_HW,
                "video path: cv2 does not read back the MJPG AVI it wrote")

        noisy = VideoSymbolPipeline(cfg, sd)
        det = VideoSymbolPipeline(cfg, sd, noise=False)
        both = {"fused_conv01": per_run, "lstm_binary_concrete": per_run}
        codes, video_s = counted(lambda: noisy.run_video(str(video)), both,
                                 f"run_video noisy ({n_all} frames)")
        det_codes, det_s = counted(lambda: det.run_video(str(video)), both,
                                   "run_video noise=False")
        lim, _ = counted(lambda: noisy.run_video(str(video), limit=100),
                         {"fused_conv01": 2, "lstm_binary_concrete": 2},
                         "run_video limit=100")
        for z in (codes, det_codes):
            require(z.shape == (n_all, LATENT) and z.dtype == np.uint8
                    and set(np.unique(z)) <= {0, 1},
                    "video path: codes' shape or values")
        require(np.array_equal(lim, codes[:100]),
                "video path: limit=100 differs from the first 100 codes")

        # A missing file: OSError in the caller within 10 s.
        err = {}

        def missing():
            try:
                noisy.run_video(str(d / "missing.avi"))
            except Exception as e:  # recorded, checked below
                err["e"] = e

        def run_missing():
            th = threading.Thread(target=missing, daemon=True)
            th.start()
            th.join(10)
            return th.is_alive()

        alive, miss_s = counted(run_missing, {}, "run_video of a missing file")
        require(not alive and isinstance(err.get("e"), OSError),
                f"video path: a missing file gave {err.get('e')!r} "
                f"(still running: {alive}), not OSError within 10 s")

        # The same decoded frames through run_frames, batch by batch.
        t0 = time.perf_counter()
        frames = np.stack(list(iter_frames_cv2(video)))
        decode_s = time.perf_counter() - t0
        batches = padded_batches(frames, VIDEO_BATCH)
        require(len(batches) == per_run, "video path: batch count")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lib = np.concatenate([noisy.run_frames(b, batch_index=i)
                              for i, b in enumerate(batches)])[:n_all]
        encode_s = time.perf_counter() - t0
        lib_det = np.concatenate([det.run_frames(b)
                                  for b in batches])[:n_all]
        require(np.array_equal(det_codes, lib_det), "video path: run_video "
                "noise=False differs from run_frames on the decoded frames")
        require(np.array_equal(codes, lib), "video path: noisy run_video "
                "differs from run_frames(batch, batch_index=ordinal)")
        by_first = np.concatenate([noisy.run_frames(
            b, batch_index=i * VIDEO_BATCH)
                                   for i, b in enumerate(batches)])[:n_all]
        print(f"check video path: {n_all} codes of dim {LATENT}; run_video "
              f"equals run_frames on the same decoded batches bit for bit "
              f"(noise=False, and noisy with batch_index = the batch "
              f"ordinal); seeding by the first frame's index instead agrees "
              f"on {float((by_first == codes).mean()):.4f} of bits; limit=100 "
              f"= the first 100 codes; a missing file raised "
              f"{type(err['e']).__name__} after {miss_s:.3f} s; share of "
              f"ones {codes.mean():.3f}")
        print(f"time: run_video, {n_all} {VIDEO_HW[0]}x{VIDEO_HW[1]} MJPG "
              f"frames (file -> codes on the host), batch {VIDEO_BATCH}, "
              f"bf16, both kernels, cv2 decode: noisy "
              f"{video_s:.3f} s ({n_all / video_s:.1f} frames/s), noise=False "
              f"{det_s:.3f} s ({n_all / det_s:.1f} frames/s); decode alone "
              f"(iter_frames_cv2) {decode_s:.3f} s ({n_all / decode_s:.1f} "
              f"frames/s); encode alone ({per_run} run_frames) "
              f"{encode_s:.3f} s ({n_all / encode_s:.1f} frames/s); native "
              f"decoder: not measured (not built on this host) [{card}]")

        # The CLI's encode of the video file, no --device.
        ckpt = d / "flagship_ckpt"
        BestCheckpointer(ckpt).save({"model": sd, "optimizer": {}}, epoch=0,
                                    metric=0.0)
        buf = io.StringIO()
        out_npz = d / "sym.npz"
        with contextlib.redirect_stdout(buf):
            _, cli_s = counted(lambda: cli.main(
                ["encode", str(video), "--ckpt", str(ckpt), "--out",
                 str(out_npz), "--video", "chinese_chess"]), {},
                "cli encode <video.avi>")
        print(buf.getvalue().strip())
        sym = SymbolStore.load(out_npz)
        plain = VideoSymbolPipeline(*flagship(False))
        want = np.concatenate([plain.run_frames(b, batch_index=i)
                               for i, b in enumerate(batches)])[:n_all]
        require(len(sym) == n_all and sym.codes.shape == (n_all, LATENT)
                and np.array_equal(sym.labels, all_states),
                "video path: cli encode's SymbolStore")
        require(np.array_equal(sym.codes, want), "video path: cli encode "
                "<video> differs from the plain route's run_frames with the "
                "same batch seeds")
        print(f"check video path: cli encode <video.avi> wrote {n_all} codes "
              f"with their labels, equal to the plain route's run_frames "
              f"(the CLI keeps svtpu's kernel defaults) bit for bit; time "
              f"{cli_s:.3f} s ({n_all / cli_s:.1f} frames/s) [{card}]")
        del frames, batches

        trunk = trunk_variants(card, sd)

        # Multi-video training and evaluation through the CLI.
        ff = d / "transition_flags.txt"
        flags_line = (f"[{', '.join(map(str, meta.flags))}], last_frame = "
                      f"{meta.last_frame}, grey_out = {meta.grey_out}\n")
        ff.write_text(f"a:\n{flags_line}b:\n{flags_line}")
        dirs = []
        t0 = time.perf_counter()
        for name, seed in (("a", 31), ("b", 32)):
            dirs.append(d / name)
            write_jpegs(dirs[-1], video_frames(meta, all_states, seed=seed))
        print(f"multi-video: wrote 2 x {n_all} seeded 256x256 JPEGs in "
              f"{time.perf_counter() - t0:.1f} s")
        multi = ["--multi", f"a={dirs[0]}", "--multi", f"b={dirs[1]}",
                 "--flags-file", str(ff)]
        mckpt = d / "multi_ckpt"
        made = []

        class Recording(trainer_mod.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        walls = {}
        saved = trainer_mod.Trainer
        trainer_mod.Trainer = Recording
        try:
            for what, argv in (
                    ("train", ["train", "--preset", "multi-video", *multi,
                               "--epochs", "2", "--save-path", str(mckpt)]),
                    ("eval-hamming", ["eval-hamming", *multi, "--ckpt",
                                      str(mckpt), "--latent-dim", "25",
                                      "--out-dir", str(d / "mh")]),
                    ("eval-consistency", [
                        "eval-consistency", *multi, "--ckpt", str(mckpt),
                        "--latent-dim", "25", "--trials", "2", "--out-dir",
                        str(d / "mc")])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    _, walls[what] = counted(lambda: cli.main(argv), {},
                                             f"cli {what} --multi")
                lines = [ln for ln in buf.getvalue().splitlines() if ln]
                print(f"  {what} --multi output: {lines[-3:]}")
        finally:
            trainer_mod.Trainer = saved
        require(len(made) == 1, "multi-video: one Trainer expected")
        bank, subs = made[0]._bank, made[0].store.stores
        require(bank is not None and bank.device.type == "cuda"
                and bank.numel() == sum(s.array.size for s in subs)
                and tuple(bank.shape) == (2 * n_all, 256, 256, 3),
                f"multi-video: the bank is not one card tensor of both "
                f"videos ({None if bank is None else tuple(bank.shape)})")
        ham = (d / "mh" / "hamming.csv").read_text().strip().splitlines()
        require(len(ham) == 1 + 9, f"multi-video: eval-hamming wrote "
                f"{len(ham)} rows, expected 1 + 9 (10 global states)")
        require((d / "mc" / "consistency.csv").exists(),
                "multi-video: eval-consistency wrote no CSV")
        print(f"check multi-video: the bank is one {bank.dtype} tensor "
              f"{tuple(bank.shape)} on {bank.device} "
              f"({bank.numel() / 2 ** 20:.1f} MiB, the sum of both videos'); "
              f"eval-hamming's CSV has 1 + 9 rows; times: train 2 epochs "
              f"{walls['train']:.2f} s, eval-hamming "
              f"{walls['eval-hamming']:.2f} s, eval-consistency --trials 2 "
              f"{walls['eval-consistency']:.2f} s [{card}]")
    print(f"video path: phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total} [{card}]")
    return {"launches": total, "int8": trunk}


def trunk_variants(card: str, sd) -> dict:
    """int8, s2d and d2s on the card against their direct routes: errors in
    f32 (TF32 off), times in bf16."""
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.ops import conv as conv_ops

    bf16 = torch.bfloat16

    def model(dtype="bfloat16", **flags):
        cfg = rbvae_variant("contrastive", LATENT, compute_dtype=dtype,
                            **flags)
        m = Seq2SeqBinaryVAE(cfg)
        m.load_state_dict(sd)
        return m

    int8 = model(int8_trunk=True, pallas_sampler=True)
    plain = model()
    kernel = model(pallas_trunk=True, pallas_sampler=True)
    rng = np.random.default_rng(41)
    x = (torch.from_numpy(rng.integers(0, 256, (BATCH, 256, 256, 3),
                                       np.uint8)).cuda().float() / 255.0)
    meta, _, _, states = train_video()
    x_eval = (torch.from_numpy(video_frames(meta, states)).cuda().float()
              / 255.0)
    acc_fn = conv_ops.int8_conv_accumulate
    with torch.inference_mode():
        # conv1's and conv2's int32 accumulators on the int8 route's own
        # inputs: the tensor-core GEMM route against the plain f32 conv.
        convs = int8.encoder_cnn.convs()
        h = convs[0](x.to(bf16).permute(0, 3, 1, 2), bf16).relu()
        accs = []
        for i, c in enumerate(convs[1:], 1):
            xq, kq, _, _ = conv_ops.int8_quantize(h, c.weight)
            acc = acc_fn(xq, kq, 2, 1)
            ref = conv_ops.int8_conv_accumulate_plain(xq, kq, 2, 1)
            require(torch.equal(acc, ref), f"int8: conv{i}'s int32 "
                    f"accumulators differ from the plain version's")
            accs.append((tuple(acc.shape), int(acc.abs().max())))
            h = conv_ops.conv2d_int8(h, c.weight, c.bias, 2, 1, bf16)
            if i < len(convs) - 1:
                h = h.relu()
        print(f"check int8 trunk: conv1's and conv2's int32 accumulators "
              f"(shape, max |acc|: {accs}) equal the plain version's (f32 "
              f"conv, TF32 off) exactly, B={BATCH}")
        # Where conv1's int8 time goes, stage by stage.
        c1 = convs[1]
        h0 = convs[0](x.to(bf16).permute(0, 3, 1, 2), bf16).relu()
        xq, kq, asc, ksc = conv_ops.int8_quantize(h0, c1.weight)
        acc = conv_ops._int8_conv_gemm(xq, kq, 2, 1)
        stages = {
            "quantise": lambda: conv_ops.int8_quantize(h0, c1.weight),
            "im2col + _int_mm": lambda: conv_ops._int8_conv_gemm(
                xq, kq, 2, 1),
            "dequantise + bias": lambda: (
                acc.float() * (asc * ksc).view(1, -1, 1, 1)).to(bf16)
            + c1.bias.to(bf16).view(1, -1, 1, 1),
            "the direct bf16 conv (cuDNN)": lambda: F.conv2d(
                h0, c1.weight.to(bf16), None, 2, 1)}
        split = {k: cuda_ms(f, warmup=2, trials=3, iters=3)[0]
                 for k, f in stages.items()}
        print("time: int8 conv1 at B=512 by stage: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in split.items()) + f" [{card}]")
        del h0, xq, acc
        match = {}
        for name, xs in (("512 seeded frames", x),
                         ("396 eval-cell frames", x_eval)):
            acc_fn.launches = 0
            a = int8.encode(xs[:, None], TEMPERATURE, True)
            require(acc_fn.launches == 2, "int8: model.encode took the "
                    f"GEMM route {acc_fn.launches} times, expected 2")
            b = plain.encode(xs[:, None], TEMPERATURE, True)
            match[name] = float((a == b).float().mean())
        times = {}
        for name, m in (("int8 (conv1, conv2 int8; sampler kernel)", int8),
                        ("bf16 plain", plain),
                        ("fused_conv01 + lstm_binary_concrete", kernel)):
            times[name] = cuda_ms(lambda: m.encode(
                x[:, None], TEMPERATURE, True), warmup=3, iters=5)
    print(f"check int8 trunk: deterministic code match against the bf16 "
          f"plain route {match} (svtpu/config.py:190-198 asks for this rate "
          f"per checkpoint; no limit is set)")
    print(f"time: model.encode, B={BATCH}, bf16, deterministic: " + "; ".join(
        f"{k} {ms:.3f} ms (spread {sp:.3f})" for k, (ms, sp) in times.items())
        + f" [{card}]")

    # conv0 by space-to-depth against cuDNN's direct conv, B=512.
    w0 = plain.encoder_cnn.convs()[0].weight
    xc = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        errs = {}
        for dt in (torch.float32, bf16):
            direct = F.conv2d(xc.to(dt), w0.to(dt), None, 2, 1).float()
            s2d = conv_ops.conv_s2d_k3s2p1(xc.to(dt), w0.to(dt)).float()
            errs[dt] = (float((s2d - direct).abs().max()),
                        float(direct.abs().max()))
        xb, wb = xc.to(bf16), w0.to(bf16)
        t_direct = cuda_ms(lambda: F.conv2d(xb, wb, None, 2, 1))
        t_s2d = cuda_ms(lambda: conv_ops.conv_s2d_k3s2p1(xb, wb))
    e32, scale = errs[torch.float32]
    require(e32 <= 1e-5 * scale, f"s2d: f32 max abs err {e32} against the "
            f"direct conv (limit {1e-5 * scale})")
    print(f"time: conv0 3->64 k3/s2/p1, B={BATCH}, bf16: direct (cuDNN) "
          f"{t_direct[0]:.3f} ms (spread {t_direct[1]:.3f}), space-to-depth "
          f"{t_s2d[0]:.3f} ms (spread {t_s2d[1]:.3f}); s2d max abs err "
          f"against direct: f32 {e32:.3e} (limit {1e-5 * scale:.3e}), bf16 "
          f"{errs[bf16][0]:.3e} [{card}]")

    # The decoder by depth-to-space at the flagship train shape.
    n = 2 * FLAGSHIP_TRAIN["batch_size"] * 5
    z = torch.from_numpy(rng.uniform(0, 1, (n, LATENT)).astype(
        np.float32)).cuda()

    def fwd_bwd(m):
        m.zero_grad(set_to_none=True)
        y = m.decoder_cnn(z)
        y.float().square().mean().backward()
        return y.detach().float(), {k: p.grad.float() for k, p in
                                    m.decoder_cnn.named_parameters()}

    errs = {}
    for dt in ("float32", "bfloat16"):
        (yd, gd), (y2, g2) = (fwd_bwd(model(dt, deconv_d2s=flag))
                              for flag in (False, True))
        errs[dt] = (float((y2 - yd).abs().max()), max(
            float((g2[k] - g).abs().max()) / max(float(g.abs().max()),
                                                 1e-30)
            for k, g in gd.items()))
    require(errs["float32"][0] <= 1e-5 and errs["float32"][1] <= 1e-4,
            f"d2s: f32 output err {errs['float32'][0]}, relative gradient "
            f"err {errs['float32'][1]}")
    t_fwd, t_bwd = {}, {}
    for k, m in (("direct", plain), ("d2s", model(deconv_d2s=True))):
        with torch.no_grad():
            t_fwd[k] = cuda_ms(lambda: m.decoder_cnn(z), warmup=3)
        t_bwd[k] = cuda_ms(lambda: m.decoder_cnn(z).float().square()
                           .mean().backward(), warmup=3, iters=5)
    print(f"time: decoder (fc + 3 transposed convs) at the flagship train "
          f"shape [{n}, {LATENT}] -> [{n}, 256, 256, 3], bf16: forward "
          f"direct {t_fwd['direct'][0]:.3f} ms, d2s {t_fwd['d2s'][0]:.3f} "
          f"ms; forward+backward direct {t_bwd['direct'][0]:.3f} ms, d2s "
          f"{t_bwd['d2s'][0]:.3f} ms; d2s against direct: max abs err of the "
          f"output, and largest gradient error over its tensor's max: f32 "
          f"{errs['float32'][0]:.3e}, {errs['float32'][1]:.3e} (limits 1e-5, "
          f"1e-4); bf16 {errs['bfloat16'][0]:.3e}, "
          f"{errs['bfloat16'][1]:.3e} [{card}]")
    return {"match": match, "ms": {k: v[0] for k, v in times.items()}}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_label(name: str) -> str:
    """A device event's name without its template and argument lists."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name[:72]


def trace_breakdown(logdir: Path, steps: int, by_op: bool = True) -> dict:
    """The device's busy share of a ``trace`` window and its top ops, from
    the Chrome trace ``trace`` wrote: device events are those of the
    "kernel", "gpu_memcpy" and "gpu_memset" categories, each named by the
    operator that launched it (its "External id"; not with ``by_op=False``,
    as a graph's replay launches no operator) and its kernel; the window
    spans every event of the trace; busy time is the union of the device
    intervals."""
    path = max(logdir.glob("*.json"), key=lambda p: p.stat().st_mtime)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    ops = {e["args"]["External id"]: e.get("name", "?") for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    dev = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
         (f"{ops.get(e.get('args', {}).get('External id'), '?')} -> "
          if by_op else "") + kernel_label(e.get("name", "?")))
        for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    require(len(dev) > 0, "trace: no device events (CUPTI recorded none)")
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, t, _ in dev:
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = s, t
        else:
            cur_hi = max(cur_hi, t)
    busy += cur_hi - cur_lo
    by_name = {}
    for s, t, name in dev:
        n, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, tot + t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo), "device_events": len(dev),
            "kernel_ms_sum": sum(t - s for s, t, _ in dev) / 1e3,
            "steps": steps,
            "top": [(name, n, tot / 1e3) for name, (n, tot) in top],
            "counts": {name: n for name, (n, _) in by_name.items()}}


def phase_rest_path(card: str) -> dict:
    """The last module slice on the card, in one process:

      * ``environment_report()`` (the smoke test must pass and name the
        card);
      * ``summarize`` of the flagship (256x256, bf16) on the card, its table
        equal to the CPU's;
      * ``ema_update`` over the flagship's parameters: 100 updates under
        ``torch.cuda.set_sync_debug_mode("error")`` against a float64 CPU
        replay, and one update's time;
      * ``sweep --variant contrastive_p --count 2 --epochs 2 --no-wandb``
        as a user runs it (``cli.main``, no ``--device``) on
        ``train_video()``'s 396 frames as 256x256 JPEGs, then
        ``eval-tradeoff --sweep-dir`` (two points), then the same sweep
        again, which resumes both trials without a train step; every
        kernel's launches 0 (the sweep keeps ``svtpu``'s defaults);
      * data and tensor parallelism over a single-rank NCCL group: the
        flagship ``Trainer`` on a (1,) data mesh (2 fused epochs,
        deterministic algorithms) bit-identical to the one without a mesh,
        a (1, 1) data x model mesh within 1e-5 of it in float32, and
        ``PerceptualEncoder(mesh=...)`` at the SD first stage's published
        widths bit-identical to the encoder without one on 8 frames; the
        group is torn down before the phase returns.

    Its kernel launches (the parallel runs' probes and encode) go to the
    kernels line."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from svtpu_torch import cli
    from svtpu_torch.config import PerceptualConfig, TrainConfig
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.models.visualize import summarize
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete
    from svtpu_torch.parallel import distributed
    from svtpu_torch.parallel.mesh import make_mesh
    from svtpu_torch.parallel.sharding import full_state_dict
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.training import ema
    from svtpu_torch.training import trainer as trainer_mod
    from svtpu_torch.training.trainer import Trainer
    from svtpu_torch.utils.env_check import environment_report

    t_phase = time.perf_counter()
    counters = {"fused_conv01": fused_conv01,
                "lstm_binary_concrete": lstm_binary_concrete,
                "binary_concrete": binary_concrete_fused,
                "flash_attention": flash_attention}
    total = dict.fromkeys(counters, 0)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    # 1. The environment report.
    rep = environment_report()
    print("environment_report: " + json.dumps(rep))
    name = torch.cuda.get_device_name(0)
    require(rep["device_smoke_test"] is True and name in rep["devices"],
            f"environment report: smoke test {rep['device_smoke_test']}, "
            f"devices {rep['devices']}")

    # 2. The flagship's summary, on the card and on the CPU.
    fcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    table = summarize(fcfg)
    card_s = time.perf_counter() - t0
    require(table == summarize(fcfg, device="cpu"),
            "summarize: the card's table differs from the CPU's")
    totals = [ln for ln in table.splitlines()
              if ln.startswith(("parameters held", "trainable"))]
    print(f"summarize flagship (latent {LATENT}, 256x256, bf16): "
          f"{len(table.splitlines())} lines, equal on the card and the CPU; "
          f"{'; '.join(totals)}; {card_s:.2f} s on the card [{card}]")

    # 3. EMA over the flagship's parameters, against a float64 CPU replay.
    model = Seq2SeqBinaryVAE(fcfg, device="cuda")
    params = dict(model.named_parameters())
    state = ema.ema_init(params)
    replay = {k: v.detach().cpu().double() for k, v in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for n in range(1, 101):
        with torch.no_grad():
            for p in params.values():
                p.add_(torch.randn(p.shape, generator=gen, device="cuda"),
                       alpha=0.01)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = ema.ema_update(state, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        d = min(0.9999, (1.0 + n) / (10.0 + n))
        for k, p in params.items():
            replay[k] -= (1.0 - d) * (replay[k] - p.detach().cpu().double())
    rel = max(float((state.ema[k].double().cpu() - r).abs().max()
                    / r.abs().max()) for k, r in replay.items())
    ms, sp = cuda_ms(lambda: ema.ema_update(state, params), iters=20)
    nbytes = 3 * sum(p.numel() * p.element_size() for p in params.values())
    print(f"check ema_update: {state.updates} updates over the flagship's "
          f"{sum(p.numel() for p in params.values()):,} parameters under "
          f"set_sync_debug_mode('error'), against a float64 CPU replay: max "
          f"error / its tensor's max {rel:.2e} (limit 1e-6); one update "
          f"{ms:.4f} ms (CUDA events, spread {sp:.3f}), bound "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes) [{card}]")
    require(rel <= 1e-6, "ema_update disagrees with its float64 replay")
    del model, params, state

    meta, splits, ids, states = train_video()
    frames = video_frames(meta, states)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # 4. The sweep as a user runs it, the trade-off, the resume.
        write_jpegs(d / "frames", frames, ids)
        video = ["--video", "chinese_chess", "--frames-dir",
                 str(d / "frames")]
        sweep = sweep_argv(d / "frames", d / "sweep")
        steps = [0]
        step = Trainer._step

        def counted_step(self, *a, **k):
            steps[0] += 1
            return step(self, *a, **k)

        runs = {}
        trainer_mod.Trainer._step = counted_step
        try:
            for what, argv in (
                    ("sweep", sweep),
                    ("eval-tradeoff", ["eval-tradeoff", *video,
                                       "--sweep-dir", str(d / "sweep"),
                                       "--out-dir", str(d / "trade")]),
                    ("resume", sweep)):
                zero()
                steps[0] = 0
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    cli.main(argv)
                torch.cuda.synchronize()
                runs[what] = (buf.getvalue(), time.perf_counter() - t0,
                              launches(), steps[0])
        finally:
            trainer_mod.Trainer._step = step
        out, wall, got, n_steps = runs["sweep"]
        res = json.loads((d / "sweep" / "sweep_results.json").read_text())
        secs = [float(m) for m in re.findall(r" in ([0-9.]+)s$", out, re.M)]
        for t, (trial, s) in enumerate(zip(res["trials"], secs)):
            c = trial["config"]
            print(f"sweep trial {t}: latent {c['latent_dim']}, batch "
                  f"{c['batch_size']}, lr {c['learning_rate']:.3g}, margin "
                  f"{c['margin']:.3f}, alpha {c['alpha']:.3f}, beta_kl "
                  f"{c['beta_kl']:.4f}, noise {c['noise_ratio']:.3f}: "
                  f"best_combined_score {trial['best_combined_score']:.4f} "
                  f"in {s:.1f} s (2 epochs, bf16) [{card}]")
        print(f"cli sweep --count 2 --epochs 2: {wall:.2f} s, {n_steps} "
              f"train steps, launches {got}; best "
              f"{res['metric']} {res['best']:.4f} [{card}]")
        require(len(res["trials"]) == 2 and len(secs) == 2,
                "sweep: two trials expected")
        require(all(np.isfinite(t["best_combined_score"])
                    for t in res["trials"]), "sweep: non-finite score")
        for what, (out, wall, got, n_steps) in runs.items():
            require(all(v == 0 for v in got.values()),
                    f"cli {what}: kernel launches {got}, expected none")
        _, t_wall, _, _ = runs["eval-tradeoff"]
        rows = (d / "trade" / "tradeoff.csv").read_text().strip() \
            .splitlines()
        print(f"cli eval-tradeoff --sweep-dir: {len(rows) - 1} points in "
              f"{t_wall:.2f} s: {rows[1:]} [{card}]")
        require(len(rows) == 3, "eval-tradeoff: two points expected")
        r_out, r_wall, _, r_steps = runs["resume"]
        print(f"cli sweep again over the same directory: "
              f"{r_out.count('resumed')} trials resumed, {r_steps} train "
              f"steps, {r_wall:.2f} s")
        require(r_out.count("resumed") == 2 and r_steps == 0,
                "sweep resume: both trials must resume without training")
        total = {k: total[k] + sum(r[2][k] for r in runs.values())
                 for k in total}

    # 5. Data and tensor parallelism over a single-rank NCCL group. The
    # runs without a mesh come first, before any process group exists.
    mcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16",
                         pallas_trunk=True, pallas_sampler=True)
    tcfg = TrainConfig(**FLAGSHIP_TRAIN)
    store = MemoryStore(frames, ids)

    def train(cfg, mesh=None):
        tr = Trainer(cfg, tcfg, store, splits, meta.flags, mesh=mesh,
                     device="cuda")
        return tr, tr.train(num_epochs=2)

    def params_of(hist):
        """Whole float32 parameters (``DTensor``s gathered: call it while
        the group is up)."""
        return {k: v.float() for k, v in
                full_state_dict(hist["final_state"].model).items()}

    f32 = dataclasses.replace(mcfg, compute_dtype="float32")
    g = np.random.default_rng(13)
    sd_frames = g.integers(0, 256, (PERCEP_BATCH, 704, 1280, 3), np.uint8)
    weights = percep_weights(sd_frames[:2])
    pcfg = PerceptualConfig(compute_dtype="bfloat16")

    def encoder(mesh=None):
        return PerceptualEncoder(weights["ae"], pcfg, batch_size=PERCEP_BATCH,
                                 seed=3, mesh=mesh)

    saved_env = {k: os.environ.pop(k) for k in
                 ("WORLD_SIZE", "MASTER_ADDR", "TORCHELASTIC_RUN_ID")
                 if k in os.environ}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, ref_bf16 = train(mcfg)
            _, ref_f32 = train(f32)
        z_ref = encoder().encode_frames(sd_frames)
        require(distributed.initialize() is False
                and not dist.is_initialized(),
                "initialize() without a launcher must be a no-op")
        port = free_port()
        require(distributed.initialize(
            init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0),
            "initialize() with an address must start the group")
        backend = dist.get_backend()
        require(backend == "nccl", f"backend {backend}, expected nccl")
        try:
            zero()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                dp_tr, dp = train(mcfg, make_mesh((1,), ("data",)))
                dp_wall = time.perf_counter() - t0
                tp_tr, tp = train(f32, make_mesh((1, 1), ("data", "model")))
            dp_params, tp_params = params_of(dp), params_of(tp)
            mesh = make_mesh((1,), ("data",))
            enc = encoder(mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = enc.encode_frames(sd_frames)
            enc_s = time.perf_counter() - t0
            got = launches()
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        os.environ.update(saved_env)
    require(not dist.is_initialized(), "the process group is still up")
    fcs = [getattr(m.fc.weight, "placements", None)
           for m in (tp["final_state"].model.encoder_cnn,
                     tp["final_state"].model.decoder_cnn)]
    require(dp_tr._data_group is not None and tp_tr._data_group is not None
            and fcs == [(Shard(1),), (Shard(0),)],
            f"the mesh trainers did not take the parallel path ({fcs})")
    a, b = dp_params, params_of(ref_bf16)
    dp_err = max(float((a[k] - b[k]).abs().max()) for k in b)
    a, b = tp_params, params_of(ref_f32)
    tp_errs = {k: float((a[k] - b[k]).abs().max() / b[k].abs().max()
                        .clamp_min(1e-30)) for k in b}
    tp_worst = max(tp_errs, key=tp_errs.get)
    tp_rel = tp_errs[tp_worst]
    z_err = float(np.abs(z - z_ref).max())
    print(f"check data parallel on one card (NCCL, world 1): the flagship "
          f"Trainer on a (1,) data mesh, 2 fused epochs (bf16, batch 32, "
          f"deterministic algorithms, {dp_wall:.2f} s), against the one "
          f"without a mesh: max |param diff| {dp_err:.3e} (must be 0); a "
          f"(1, 1) data x model mesh in float32 (encoder_cnn.fc "
          f"RowwiseParallel {fcs[0]}, decoder_cnn.fc ColwiseParallel "
          f"{fcs[1]}): max error / its "
          f"tensor's max {tp_rel:.2e} ({tp_worst}; limit 1e-5); "
          f"PerceptualEncoder on a "
          f"(1,) mesh, {PERCEP_BATCH} frames 704x1280 at the SD first "
          f"stage's widths (stochastic, bf16): max |latent diff| "
          f"{z_err:.3e} (must be 0), {enc_s:.2f} s; launches on the mesh "
          f"runs {got} [{card}]")
    require(dp_err == 0.0, "(1,) data mesh: parameters differ")
    require(tp_rel <= 1e-5, "(1, 1) mesh: parameters disagree")
    require(z_err == 0.0, "data-parallel PerceptualEncoder: latents differ")
    require(got["flash_attention"] == 1,
            f"data-parallel encode: {got['flash_attention']} flash_attention "
            f"launches, expected 1 (one batch)")
    require(got["fused_conv01"] > 0 and got["lstm_binary_concrete"] > 0,
            "the mesh trainers' probes did not run the kernels")
    total = {k: total[k] + got[k] for k in total}
    print("distributed: one rank here; more ranks, one a card, in "
          "phase_multi_card (the 2- and 4-rank semantics also in the CPU "
          "tests, tests/test_torch_parallel.py, gloo)")
    print(f"rest path: all checks passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {total} [{card}]")
    return {"launches": total}


def kernel_counters() -> dict:
    """The four kernel wrappers by name; each counts its launches."""
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.lstm_cuda import lstm_binary_concrete

    return {"fused_conv01": fused_conv01,
            "lstm_binary_concrete": lstm_binary_concrete,
            "binary_concrete": binary_concrete_fused,
            "flash_attention": flash_attention}


def zero_counts(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def nvlink_gbps():
    """Card 0's NVLink rate in one direction, GB/s: the sum of its links'
    rates as ``nvidia-smi nvlink -s -i 0`` prints them ("Link k: 26.562
    GB/s"); None where it lists no active link."""
    proc = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                          capture_output=True, text=True)
    rates = [float(m) for m in re.findall(r"Link \d+: ([0-9.]+) GB/s",
                                          proc.stdout)]
    return sum(rates) if rates else None


class Torchrun:
    """``python3 -m torch.distributed.run --standalone --nproc-per-node
    world <args>`` started from the repo root, its output to files under
    ``logdir``. ``wait`` gives its return code (0
    only when every rank exited 0), its output and its wall seconds;
    ``close`` kills the launcher and its ranks if they still run."""

    def __init__(self, world: int, args: list, logdir: Path, **env):
        self.t0 = time.perf_counter()
        self.out = open(logdir / f"torchrun{id(self)}.out", "w+")
        self.err = open(logdir / f"torchrun{id(self)}.err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), *[str(a) for a in args]],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), **env),
            stdout=self.out, stderr=self.err, text=True)

    def wait(self, timeout: float = 300):
        try:
            rc = self.proc.wait(timeout=timeout)
            self.out.seek(0)
            self.err.seek(0)
            return (rc, self.out.read(), self.err.read(),
                    time.perf_counter() - self.t0)
        finally:
            self.close()

    def close(self) -> None:
        if self.proc.poll() is None:
            # SIGTERM: the launcher stops its ranks (each in a session of
            # its own) before it exits.
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.out.close()
        self.err.close()


def flagship_step_ms(tr, steps: int = 12, graphed: bool = True):
    """The median CUDA-event time of a flagship train step (after 2) of a
    fresh state on the graph route (replays, after the warm-up steps and
    the capture) or the eager route, over steps of epoch 0; every rank of
    ``tr``'s mesh steps with it. Returns it and the state."""
    tr._graphed = graphed
    st = tr.init_state()
    idx = tr._upload_epoch(0)
    for i in range(3):
        tr._step(st, idx[i % len(idx)])
    times = []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr._step(st, idx[i % len(idx)])
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times[2:]), st


def trace_steps(tr, st, n: int = 5) -> dict:
    """``trace_breakdown`` of ``n`` more train steps of ``st`` on ``tr``'s
    route, over steps of epoch 0 (the device's busy share of the window)."""
    import tempfile

    from svtpu_torch.utils import profiling

    idx = tr._upload_epoch(0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for i in range(n):
                tr._step(st, idx[i % len(idx)])
            torch.cuda.synchronize()
        return trace_breakdown(Path(tmp), n)


def step_graph_counts() -> dict:
    """The step graphs captured and the steps replayed in this process."""
    from svtpu_torch.training.step_graph import StepGraph

    return {"captures": StepGraph.captures, "replays": StepGraph.replays}


@contextlib.contextmanager
def eager_steps():
    """Every ``Trainer`` built inside takes the eager route on the card, its
    Adam still capturable, so that both routes do the same arithmetic: the
    reference the graph route is held against."""
    from svtpu_torch.training.trainer import Trainer

    init = Trainer.__init__

    def eager_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._graphed = False

    Trainer.__init__ = eager_init
    try:
        yield
    finally:
        Trainer.__init__ = init


def train_state_bits(state) -> dict:
    """A train state's parameters and Adam state (moments and step counts),
    on the host, by name."""
    out = {f"param {k}": v.detach().cpu()
           for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": torch.as_tensor(v).detach().cpu()
                    for k, v in s.items()})
    return out


def replay_seeds() -> list:
    """A CUDA graph that draws twice from a persistent generator
    (``draws.Replicas``, registered with the graph), replayed after seeding
    it anew with 11 and then 12: for each seed, whether its offset was 0
    before the replay and both draws equal a fresh generator's with that
    seed (the replay's prologue reads the seed and offset the host holds)."""
    from svtpu_torch.ops.draws import Replicas

    reps = Replicas("cuda", 0)
    gen = reps.take()
    torch.rand(1024, generator=gen, device="cuda")
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        first = torch.rand(1024, generator=gen, device="cuda")
        second = torch.rand(1024, generator=gen, device="cuda")
    out = []
    for seed in (11, 12):
        reps.seed(seed)
        offset = gen.get_offset()
        graph.replay()
        fresh = torch.Generator("cuda").manual_seed(seed)
        out.append({"seed": seed, "offset_before": offset,
                    "draws_equal": torch.equal(first, torch.rand(
                        1024, generator=fresh, device="cuda"))
                    and torch.equal(second, torch.rand(
                        1024, generator=fresh, device="cuda"))})
    return out


def adam_against_optax(tr) -> float:
    """Two steps of ``tr``'s Adam (capturable on the card, eager) on the
    flagship's initial parameters with seeded gradients, against optax's
    ``adam`` (``scale_by_adam``: bias-corrected moments, ``eps`` outside
    the root, ``eps_root`` 0; then ``-lr``) computed in float64 on the host:
    the largest |difference| of a parameter."""
    cfg = tr.cfg
    st = tr.init_state()
    params = [p for g in st.optimizer.param_groups for p in g["params"]]
    ref = [p.detach().double().cpu() for p in params]
    mu = [torch.zeros_like(r) for r in ref]
    nu = [torch.zeros_like(r) for r in ref]
    gen = torch.Generator().manual_seed(5)
    for t in (1, 2):
        grads = [torch.randn(p.shape, generator=gen, dtype=torch.float64)
                 * 1e-3 for p in params]
        for p, g in zip(params, grads):
            p.grad = g.to(p.device, p.dtype)
        st.optimizer.step()
        for i, g in enumerate(grads):
            g = g.float().double()
            mu[i] = 0.9 * mu[i] + 0.1 * g
            nu[i] = 0.999 * nu[i] + 0.001 * g * g
            ref[i] -= cfg.learning_rate * (mu[i] / (1 - 0.9 ** t)) / (
                torch.sqrt(nu[i] / (1 - 0.999 ** t)) + 1e-8)
    return max(float((p.detach().double().cpu() - r).abs().max())
               for p, r in zip(params, ref))


# Raised above the flagship schedule's temperature from step 4 on (2.0,
# then 1.992 at step 4), so the steps after it take the floor.
ROUTE_FLOOR = 1.995


def routes_agree(make_trainer) -> dict:
    """One fresh state trained through the step graph and one through the
    eager route (``make_trainer()`` builds the same trainer twice, with the
    same initial parameters), deterministic algorithms on: two epochs one
    step at a time (the two warm-up steps, the capture and its replay, the
    anneal update at step 4 a replay), the floor raised to ``ROUTE_FLOOR``,
    a staged epoch whose steps run under sync-debug "error" (replays only:
    a capture synchronises), one more epoch one step at a time. Returns
    whether every epoch's metrics (the staged epoch's sums on the device),
    parameter and Adam tensor agree bit for bit, the names that differ,
    the epochs' mean temperatures, the step graphs captured and replayed,
    and the capture's seconds."""
    runs = {}
    for graphed in (True, False):
        tr = make_trainer()
        tr._graphed = graphed
        st = tr.init_state()
        c0 = step_graph_counts()
        metrics = [tr._per_step_epoch(st, 0)[0], tr._per_step_epoch(st, 1)[0]]
        tr._temp_floor = ROUTE_FLOOR
        idx = tr._upload_epoch(2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vec, temps = tr._fused_steps(st, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        metrics.append({"sums": vec.cpu(), "temperature": temps / len(idx)})
        metrics.append(tr._per_step_epoch(st, 3)[0])
        c1 = step_graph_counts()
        runs[graphed] = dict(
            metrics=metrics, bits=train_state_bits(st), steps=st.step,
            counts={k: c1[k] - c0[k] for k in c1},
            capture_s=st.graph.capture_s if st.graph else None)
    g, e = runs[True], runs[False]
    differ = sorted(k for k in e["bits"] if not torch.equal(g["bits"][k],
                                                            e["bits"][k]))
    same_metrics = all(
        (torch.equal(a["sums"], b["sums"]) and a["temperature"]
         == b["temperature"]) if "sums" in a else a == b
        for a, b in zip(g["metrics"], e["metrics"]))
    return {"equal": not differ and same_metrics
            and g["bits"].keys() == e["bits"].keys(),
            "differ": differ, "metrics_equal": same_metrics,
            "tensors": len(e["bits"]), "steps": g["steps"],
            "temps": [round(m["temperature"], 6) for m in g["metrics"]],
            "graph": g["counts"], "eager": e["counts"],
            "capture_s": g["capture_s"]}


def embed_seconds(enc, frames: np.ndarray) -> float:
    """Median host seconds of ``enc.encode_frames(frames)`` over 3 runs
    after one warm-up (latents back on the host)."""
    enc.encode_frames(frames)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_frames(frames)
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


# Across cards, the parameters after 2 flagship epochs against the run
# without a launcher or mesh, as a share of each tensor's largest |value|:
# about 3x the largest sound reading (PERF.md §6), and below what a dropped
# shard or a learning rate scaled by the world gives (``multi_card_worker``
# measures both and the phase requires them above the f32 limit).
F32_PARAM_LIMIT = 1e-1
F64_PARAM_LIMIT = 5e-4


def param_limit(kind: str, latents: float) -> float:
    """The limit of a multi-card run named ``train_<dtype>_s<seed>`` (none
    for bf16), or ``latents`` for an embed."""
    if not kind.startswith("train"):
        return latents
    return {"bf16": float("inf"), "f32": F32_PARAM_LIMIT,
            "f64": F64_PARAM_LIMIT}[kind.split("_")[1]]


def rel_errors(got: dict, ref: dict) -> dict:
    """Each tensor's max |difference| over its max |value| (f32)."""
    return {k: float((got[k].float() - v.float()).abs().max()
                     / v.float().abs().max().clamp_min(1e-30))
            for k, v in ref.items()}


def latent_error(got: dict, ref: dict) -> float:
    """Max |difference| of two ``embed`` dicts over their max |value|."""
    top = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - v).max()) for k, v in ref.items()) / top


def import_seconds(card: str, root: Path = ROOT) -> dict:
    """``python3 -X importtime -c "import svtpu_torch.cli"`` in a fresh
    process on ``root``'s tree, what each launched rank pays before its
    command: the cumulative seconds of ``svtpu_torch.cli``, of ``torch`` and
    of ``torch.distributed.tensor`` under it (0 where it is not imported),
    the process's wall seconds, and then what a train command pays next:
    the seconds of building its first ``torch.optim.Adam`` (which imports
    ``torch._dynamo``); printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import svtpu_torch.cli\nimport time, torch\n"
         "t = time.perf_counter()\n"
         "torch.optim.Adam([torch.zeros(1, requires_grad=True)])\n"
         "print(time.perf_counter() - t)"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"import svtpu_torch.cli failed on "
            f"{root}:\n{proc.stderr[-3000:]}")
    cum = {}
    # A module's line follows its imports': the lines up to the CLI's are
    # what its import loaded.
    for us, mod in re.findall(r"^import time:\s+\d+ \|\s+(\d+) \| +(\S+)$",
                              proc.stderr, re.M):
        cum.setdefault(mod, int(us) / 1e6)
        if mod == "svtpu_torch.cli":
            break
    out = {"cli_s": cum["svtpu_torch.cli"], "torch_s": cum["torch"],
           "dtensor_s": cum.get("torch.distributed.tensor", 0.0),
           "wall_s": wall, "adam_s": float(proc.stdout.split()[-1])}
    print(f"start-up: python3 -X importtime -c 'import svtpu_torch.cli' on "
          f"{root}: {out['cli_s']:.3f} s cumulative, of it torch "
          f"{out['torch_s']:.3f} s and torch.distributed.tensor "
          f"{out['dtensor_s']:.3f} s (0: not imported); then the first "
          f"torch.optim.Adam (a train command's) {out['adam_s']:.3f} s; the "
          f"process {wall:.2f} s wall [{card}]")
    return out


def capture_failure_worker() -> None:
    """``chip_smoke.py --capture-failure``: a flagship ``Trainer`` on the
    card whose objective reads the loss on the host (``float``), as a step
    body must not: its warm-up steps run (eagerly, where a read is allowed)
    and its capture must raise ``StepCaptureError``, leaving no graph and
    the parameters and Adam state as the warm-up left them. Prints one JSON
    line. In a process of its own: a capture that fails leaves the capture
    stream behind."""
    from svtpu_torch.config import TrainConfig, rbvae_variant
    from svtpu_torch.training.step_graph import (WARMUP_STEPS,
                                                 StepCaptureError)
    from svtpu_torch.training.trainer import Trainer

    meta, splits, ids, states = train_video()
    tr = Trainer(rbvae_variant("contrastive", LATENT,
                               compute_dtype="bfloat16"),
                 TrainConfig(**FLAGSHIP_TRAIN),
                 MemoryStore(video_frames(meta, states), ids), splits,
                 meta.flags, device="cuda")
    objective = tr._objective()

    def reads_on_host(*args, **kwargs):
        total, metrics = objective(*args, **kwargs)
        float(total)
        return total, metrics

    tr._objective = lambda: reads_on_host
    st = tr.init_state()
    idx = tr._upload_epoch(0)
    for i in range(WARMUP_STEPS):
        tr._step(st, idx[i % len(idx)])
    torch.cuda.synchronize()
    before = train_state_bits(st)
    raised = None
    try:
        tr._step(st, idx[0])
    except StepCaptureError as e:
        raised = str(e)
    after = train_state_bits(st)
    print(json.dumps({"raised": raised, "no_graph": st.graph.graph is None,
                      "unchanged": all(torch.equal(v, after[k])
                                       for k, v in before.items())}))


def multi_card_worker(out_dir: str) -> None:
    """One rank of ``phase_multi_card``'s Python-API meshes (``chip_smoke.py
    --multi-card-worker DIR`` under ``torch.distributed.run``, 4 or more
    ranks). First, with no process group, the runs without a mesh on this
    rank's card: the flagship ``Trainer`` (f32, both kernels, 2 fused
    epochs, deterministic algorithms) and ``PerceptualEncoder`` on 8 seeded
    704x1280 frames (bf16 stochastic, f32 deterministic). Then, over NCCL,
    the same on a (world,) data mesh and, for the trainer, a (world/2, 2)
    data x model mesh; each run's per-rank launches; two faults on the
    (world,) mesh, for the parameter limit to see; and on the (world,)
    mesh the step graph against the eager route (``routes_agree``: bf16,
    f32, bf16 with remat) and the timings: the flagship's bf16 step at
    global batch 32 on both routes, the capture, a trace of 5 steps of each
    route, its packed gradient all-reduce (``all_reduce_mean_``), and the SD
    encode of 16 frames. Writes ``rank<r>.json`` into ``DIR``."""
    import dataclasses

    import torch.distributed as dist

    from svtpu_torch.config import (PerceptualConfig, TrainConfig,
                                    rbvae_variant)
    from svtpu_torch.parallel import distributed
    from svtpu_torch.parallel.mesh import make_mesh
    from svtpu_torch.parallel.sharding import full_state_dict
    from svtpu_torch.perceptual.embed import PerceptualEncoder
    from svtpu_torch.training.trainer import Trainer

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    counters = kernel_counters()
    meta, splits, ids, states = train_video()
    store = MemoryStore(video_frames(meta, states), ids)
    mcfg = rbvae_variant("contrastive", LATENT, compute_dtype="float32",
                         pallas_trunk=True, pallas_sampler=True)
    tcfg = TrainConfig(**FLAGSHIP_TRAIN)
    sd_frames = np.random.default_rng(13).integers(
        0, 256, (2 * PERCEP_BATCH, 704, 1280, 3), np.uint8)
    weights = percep_weights(sd_frames[:2])
    encoders = {"bf16 stochastic": (PerceptualConfig(), True),
                "f32 deterministic": (PerceptualConfig(
                    compute_dtype="float32"), False)}

    def trainer(mesh, cfg=mcfg, tcfg=tcfg):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Trainer(cfg, tcfg, store, splits, meta.flags, mesh=mesh,
                           device="cuda")

    def step_grads(mesh=None):
        """The gradients of epoch 0's first step, after the all-reduce
        (whole tensors), in f64 compute: in f32 a logit within rounding of
        the sampler's threshold flips a hard code, and the decoder's fc
        gradient moves by a whole row (6.6e-4 of its max at world 4)."""
        tr = trainer(mesh, dataclasses.replace(mcfg,
                                               compute_dtype="float64"))
        st = tr.init_state()
        metrics, _ = tr._train_step(st, tr._upload_epoch(0)[0])
        grads = {n: (p.grad.full_tensor() if distributed.is_dtensor(p.grad)
                     else p.grad).float().cpu()
                 for n, p in st.model.named_parameters()
                 if p.grad is not None}
        names = sorted(metrics)
        grads["losses"] = tr._data_mean(torch.stack(
            [metrics[k].double() for k in names])).cpu()
        del tr, st
        torch.cuda.empty_cache()   # f64 activations: ~4x the f32 step's
        return grads

    def train(mesh=None, tcfg=tcfg):
        zero_counts(counters)
        tr = trainer(mesh, tcfg=tcfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hist = tr.train(num_epochs=2)
        model = hist["final_state"].model
        params = {k: v.float().cpu() for k, v in
                  full_state_dict(model).items()}
        return model, params, read_counts(counters), tr._data_group

    def encode(name, mesh=None):
        cfg, stochastic = encoders[name]
        zero_counts(counters)
        enc = PerceptualEncoder(weights["ae"], cfg, batch_size=PERCEP_BATCH,
                                stochastic=stochastic, seed=3, mesh=mesh)
        z = enc.encode_frames(sd_frames[:PERCEP_BATCH])
        torch.cuda.synchronize()
        return z, read_counts(counters)

    def say(what):
        print(f"[rank {os.environ['RANK']}] {what}", flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    say("the runs without a mesh")
    ref_grads = step_grads()
    _, ref_params, ref_launches, _ = train()
    ref_z = {name: encode(name) for name in encoders}
    distributed.initialize()
    rank = dist.get_rank()
    out = {"rank": rank, "world": world, "device":
           str(torch.cuda.current_device()), "backend": dist.get_backend(),
           "reference_launches": ref_launches,
           "reference_encode_launches": {k: v[1] for k, v in ref_z.items()}}
    try:
        for name, shape, axes in (("data", (world,), ("data",)),
                                  ("data x model", (world // 2, 2),
                                   ("data", "model"))):
            say(f"trainer on a {shape} mesh")
            grads = step_grads(make_mesh(shape, axes))
            g_errs = rel_errors(grads, ref_grads)
            g_worst = max(g_errs, key=g_errs.get)
            model, params, launches, group = train(make_mesh(shape, axes))
            errs = rel_errors(params, ref_params)
            worst = max(errs, key=errs.get)
            fc = model.encoder_cnn.fc.weight
            out[f"trainer {name}"] = {
                "grad_errs": {k: v for k, v in g_errs.items() if v > 1e-6},
                "shape": list(shape), "launches": launches,
                "parallel": group is not None,
                "fc_placements": str(getattr(fc, "placements", None)),
                "grad_rel_err": g_errs[g_worst], "grad_worst": g_worst,
                "max_rel_err": errs[worst], "worst": worst,
                "worst_abs": float((params[worst]
                                    - ref_params[worst]).abs().max()),
                "worst_max": float(ref_params[worst].abs().max())}
        # Two faults the parameter limit must see, on the (world,) mesh: the
        # last rank's gradients dropped from the all-reduce, and the
        # learning rate scaled by the world.
        say("fault controls")
        all_reduce_mean_ = distributed.all_reduce_mean_

        def dropped_shard(tensors, group, n):
            if group is not None and dist.get_rank(group) == n - 1:
                for t in tensors:
                    (t.to_local() if distributed.is_dtensor(t)
                     else t).zero_()
            all_reduce_mean_(tensors, group, n)

        distributed.all_reduce_mean_ = dropped_shard
        try:
            _, params, _, _ = train(make_mesh((world,), ("data",)))
        finally:
            distributed.all_reduce_mean_ = all_reduce_mean_
        faults = {"a dropped shard": params}
        _, faults[f"lr x {world}"], _, _ = train(
            make_mesh((world,), ("data",)), dataclasses.replace(
                tcfg, learning_rate=tcfg.learning_rate * world))
        out["faults"] = {k: max(rel_errors(v, ref_params).values())
                         for k, v in faults.items()}
        for name in encoders:
            say(f"encoder {name}")
            z, launches = encode(name, make_mesh((world,), ("data",)))
            ref = ref_z[name][0]
            out[f"encoder {name}"] = {
                "launches": launches,
                "max_rel_err": float(np.abs(z - ref).max()
                                     / np.abs(ref).max())}
        # The step graph against the eager route on the (world,) mesh, bit
        # for bit on every rank (the packed all-reduce inside the graph).
        mesh = make_mesh((world,), ("data",))
        for name, cfg in (("bf16", dataclasses.replace(
                mcfg, compute_dtype="bfloat16")), ("f32", mcfg),
                ("bf16, remat", dataclasses.replace(
                    mcfg, compute_dtype="bfloat16", remat=True))):
            say(f"graph route vs eager route, {name}")
            out[f"routes {name}"] = routes_agree(
                lambda cfg=cfg: trainer(mesh, cfg))
        torch.use_deterministic_algorithms(False)
        say("timings")
        # Timings on the (world,) mesh: the CLI's flagship (bf16, svtpu's
        # kernel defaults), global batch 32.
        mesh = make_mesh((world,), ("data",))
        fcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16")
        tr = Trainer(fcfg, tcfg, store, splits, meta.flags, mesh=mesh,
                     device="cuda")
        eager_ms, est = flagship_step_ms(tr, graphed=False)
        eager_trace = trace_steps(tr, est)
        del est
        step_ms, st = flagship_step_ms(tr)
        grads = [p.grad for p in st.model.parameters() if p.grad is not None]
        group, n = tr._data_group, mesh.size("data")
        ar_ms, ar_sp = cuda_ms(lambda: distributed.all_reduce_mean_(
            grads, group, n), warmup=3, trials=5, iters=20)
        # The collective alone, on a buffer of the packed gradients' size
        # (zeros: a hundred sums in place stay finite); the rest of
        # all_reduce_mean_ is the packing (cat, divide, copy_ back).
        flat = torch.zeros(sum(g.numel() for g in grads),
                           device=grads[0].device)
        coll_ms, coll_sp = cuda_ms(lambda: dist.all_reduce(flat, group=group),
                                   warmup=3, trials=5, iters=20)
        # 5 more steps of each route, traced on every rank: does the host
        # hold the card back at a quarter of the batch?
        out["trace"] = trace_steps(tr, st)
        out["trace_eager"] = eager_trace
        capture_s = st.graph.capture_s
        # A graph that captured the group's all-reduce goes before the
        # group: destroy_process_group waits for it (it hung here).
        st.graph = None
        enc = PerceptualEncoder(weights["ae"], PerceptualConfig(),
                                batch_size=PERCEP_BATCH, seed=3, mesh=mesh)
        out["timing"] = {
            "step_ms": step_ms, "eager_step_ms": eager_ms,
            "capture_s": capture_s, "local_batch": tr._hi - tr._lo,
            "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
            "allreduce_ms": ar_ms, "allreduce_spread": ar_sp,
            "collective_ms": coll_ms, "collective_spread": coll_sp,
            "embed_s": embed_seconds(enc, sd_frames)}
        distributed.barrier()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def multi_card_meshes(card: str, world: int, world1: dict) -> dict:
    """(b) of ``phase_multi_card``, at four cards or more: the mesh
    worker (``chip_smoke.py --multi-card-worker``) under
    ``torch.distributed.run`` at ``world``, its results held and printed
    beside ``world1`` (this card's ``step_ms``, ``eager_step_ms`` and
    ``embed_s``). Returns every rank's launches and the world-N step on
    both routes and embed rate."""
    import tempfile

    from svtpu_torch.training.step_graph import WARMUP_STEPS

    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    step_ms, eager_ms = world1["step_ms"], world1["eager_step_ms"]
    embed_s = world1["embed_s"]
    frames_step = FLAGSHIP_TRAIN["batch_size"] * 2 * 5
    torch.cuda.empty_cache()   # rank 0 shares this card
    with tempfile.TemporaryDirectory() as tmp:
        rc, out, err, wall = Torchrun(world, [
            ROOT / "chip_smoke.py", "--multi-card-worker", tmp],
            Path(tmp), NCCL_DEBUG="INFO").wait(timeout=600)
        require(rc == 0, f"multi card (b): the worker failed (exit "
                f"{rc}):\n{out[-3000:]}\n{err[-4000:]}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    def worst(key, err="max_rel_err"):
        r = max(ranks, key=lambda r: r[key][err])[key]
        tensor = {"max_rel_err": "worst", "grad_rel_err": "grad_worst"}
        return f"{r[err]:.3e}" + (
            f" ({r[tensor[err]]}"
            + (f": max |diff| {r['worst_abs']:.3e}, max |value| "
               f"{r['worst_max']:.3e}" if err == "max_rel_err" else "")
            + ")" if tensor[err] in r else "")

    r0 = ranks[0]
    print(f"check multi card (b), {world} ranks over NCCL ({wall:.1f} s "
          f"with start-up): flagship Trainer f32, both kernels, against "
          f"the run without a mesh, max error / its tensor's max over "
          f"the ranks: one step's gradients after the all-reduce in f64 "
          f"compute ({world},) {worst('trainer data', 'grad_rel_err')}, "
          f"({world // 2}, 2) "
          f"{worst('trainer data x model', 'grad_rel_err')} (limit "
          f"1e-5; encoder_cnn.fc placements "
          f"{r0['trainer data x model']['fc_placements']}); the "
          f"parameters after 2 fused epochs in f32 ({world},) "
          f"{worst('trainer data')}, ({world // 2}, 2) "
          f"{worst('trainer data x model')} (limit {F32_PARAM_LIMIT:g}: "
          f"Adam's first steps carry the f32 reordering of small "
          f"gradients, PERF.md §6); "
          f"per-rank launches "
          f"{[r['trainer data']['launches'] for r in ranks]}, "
          f"{[r['trainer data x model']['launches'] for r in ranks]}, "
          f"the runs without a mesh "
          f"{[r['reference_launches'] for r in ranks]}; "
          f"PerceptualEncoder ({world},) on {PERCEP_BATCH} frames "
          f"({PERCEP_BATCH // world} a rank): bf16 stochastic "
          f"{worst('encoder bf16 stochastic')} (limit 2e-2), f32 "
          f"deterministic {worst('encoder f32 deterministic')} (limit "
          f"1e-5); encode launches per rank "
          f"{[r['encoder bf16 stochastic']['launches'] for r in ranks]}"
          f" [{card}]")
    faults = {k: min(r["faults"][k] for r in ranks) for k in r0["faults"]}
    print(f"check multi card (b): the parameter limit against two faults "
          f"on the ({world},) mesh, f32, smallest over the ranks: "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (each must pass the f32 limit {F32_PARAM_LIMIT:g}) [{card}]")
    require(all(v > F32_PARAM_LIMIT for v in faults.values()),
            f"multi card (b): the f32 parameter limit {F32_PARAM_LIMIT} "
            f"does not see a fault: {faults}")
    require([r["device"] for r in ranks]
            == [str(r) for r in range(world)],
            f"multi card (b): the ranks' cards "
            f"{[r['device'] for r in ranks]}")
    require(r0["trainer data x model"]["fc_placements"] == "(Shard(dim=1),)",
            "multi card (b): the (n/2, 2) mesh did not shard the fc")
    via = sorted(set(re.findall(r" via (\S+)", out)))
    for name in ("bf16", "f32", "bf16, remat"):
        got = [r[f"routes {name}"] for r in ranks]
        print(f"check multi card (b): graph route vs eager route on the "
              f"({world},) mesh, flagship {name}, {got[0]['steps']} "
              f"steps from the same state (epochs' mean temperature "
              f"{got[0]['temps']}), rank by rank: bit for bit "
              f"{[g['equal'] for g in got]}, differing "
              f"{[g['differ'][:3] for g in got]}; step graphs "
              f"{[g['graph'] for g in got]}; captures "
              f"{[round(g['capture_s'], 3) for g in got]} s [{card}]")
        require(all(g["equal"] and g["graph"] == {
            "captures": 1, "replays": g["steps"] - WARMUP_STEPS}
            for g in got), f"multi card (b): graph route vs eager route "
            f"({name}) on the ({world},) mesh: {got}")
    for key, route in (("trace", "graph"), ("trace_eager", "eager")):
        br = r0[key]
        print(f"multi card (b): trace of 5 flagship steps at world "
              f"{world} on rank 0, {route} route: window "
              f"{br['window_ms']:.3f} ms, device busy "
              f"{br['busy_ms']:.3f} ms = {br['busy_share']:.1%}; busy "
              f"share rank by rank "
              f"{[round(r[key]['busy_share'], 4) for r in ranks]}; top "
              f"ops {[(n, round(ms, 3)) for n, _, ms in br['top'][:5]]}"
              f" [{card}]")
    print(f"multi card (b): NCCL's transports between the cards "
          f"(NCCL_DEBUG=INFO): {via or 'not reported'} [{card}]")
    tm = r0["timing"]
    gbps = nvlink_gbps()
    moved = 2 * (world - 1) / world * tm["grad_bytes"]
    bound = (f"{moved / (gbps * 1e9) * 1e3:.4f} ms ({moved / 1e6:.2f} MB "
             f"over {gbps:.1f} GB/s, card 0's NVLink links summed)"
             if gbps else "not measured (nvidia-smi lists no NVLink)")
    print(f"time: multi card world {world}: flagship train step, global "
          f"batch {FLAGSHIP_TRAIN['batch_size']} ({tm['local_batch']} a "
          f"card), bf16, rank 0's CUDA events: graph route "
          f"{tm['step_ms']:.3f} ms, "
          f"{frames_step / tm['step_ms'] * 1e3:.1f} train frames/s "
          f"({step_ms / tm['step_ms']:.2f}x world 1's {step_ms:.3f} ms), "
          f"capture {tm['capture_s']:.3f} s; eager route "
          f"{tm['eager_step_ms']:.3f} ms ({eager_ms / tm['eager_step_ms']:.2f}"
          f"x world 1's {eager_ms:.3f} ms); "
          f"its packed gradient all-reduce (all_reduce_mean_, "
          f"{tm['grad_bytes'] / 1e6:.2f} MB f32): {tm['allreduce_ms']:.4f}"
          f" ms (spread {tm['allreduce_spread']:.3f}), "
          f"{tm['allreduce_ms'] / tm['step_ms']:.1%} of the step, bound "
          f"{bound}; of it the collective alone (dist.all_reduce of "
          f"the packed size) {tm['collective_ms']:.4f} ms (spread "
          f"{tm['collective_spread']:.3f}), "
          f"{tm['collective_ms'] / tm['allreduce_ms']:.1%}, the packing "
          f"(cat, divide, copy_ back) the rest; embed of "
          f"{2 * PERCEP_BATCH} frames: "
          f"{tm['embed_s']:.3f} s, {2 * PERCEP_BATCH / tm['embed_s']:.2f} "
          f"frames/s (world 1: {PERCEP_FRAMES / embed_s:.2f}) [{card}]")
    for r in ranks:
        ref = r["reference_launches"]
        require(ref["fused_conv01"] > 0
                and ref["lstm_binary_concrete"] > 0,
                "multi card (b): the reference probes ran no kernel")
        for name in ("data", "data x model"):
            t = r[f"trainer {name}"]
            require(t["parallel"] and t["launches"] == ref,
                    f"multi card (b): rank {r['rank']} trainer {name}: "
                    f"launches {t['launches']}, expected {ref}")
            require(t["max_rel_err"] <= F32_PARAM_LIMIT, f"multi card "
                    f"(b): rank {r['rank']} trainer {name}: parameters "
                    f"{t['max_rel_err']} ({t['worst']})")
            require(t["grad_rel_err"] <= 1e-5, f"multi card (b): rank "
                    f"{r['rank']} trainer {name}: gradients "
                    f"{t['grad_rel_err']} ({t['grad_worst']}); above "
                    f"1e-6: {t['grad_errs']}")
            total = add_counts(total, t["launches"])
        for name, limit in (("bf16 stochastic", 2e-2),
                            ("f32 deterministic", 1e-5)):
            e = r[f"encoder {name}"]
            want = dict.fromkeys(counters, 0)
            want["flash_attention"] = 1
            require(e["launches"] == want, f"multi card (b): rank "
                    f"{r['rank']} encoder {name}: launches "
                    f"{e['launches']}")
            require(e["max_rel_err"] <= limit, f"multi card (b): rank "
                    f"{r['rank']} encoder {name}: {e['max_rel_err']}")
            total = add_counts(total, e["launches"])
    return {"launches": total, "step_ms": tm["step_ms"],
            "eager_step_ms": tm["eager_step_ms"],
            "embed_fps": 2 * PERCEP_BATCH / tm["embed_s"]}


def phase_multi_card(card: str) -> dict:
    """The command line and the meshes over every card of the host, under
    ``python3 -m torch.distributed.run --standalone --nproc-per-node
    <world>``, world = ``torch.cuda.device_count()``:

      (a) ``train --preset flagship --epochs 2`` on ``train_video()``'s
          396 frames as JPEGs, in bf16 and with ``--dtype float32`` (at
          world > 1 also ``float64``, and f32 and f64 each at seeds 0, 1
          and 2); ``embed`` of 16 seeded 720x1280 JPEGs through the SD
          first stage (``percep_weights``), stochastic and
          ``--deterministic``; ``sweep`` (``sweep_argv``) on the same
          JPEGs; and ``eval-consistency --sd-ckpt`` (``sd_consistency_argv``)
          of a percep-flagship checkpoint trained here on the 16 SD
          JPEGs: each command one launch of ``-m svtpu_torch.cli``, one
          after another, the trains and the sweep with
          ``SVTPU_DETERMINISTIC=1``, every rank writing its launches
          (``SVTPU_LAUNCHES_DIR``). Each is held against the same command
          without a launcher, run in this process meanwhile (PyTorch's
          TF32 defaults, as the launched ranks have): at world 1 bit for
          bit, every file of the sweep and ``consistency.csv`` included; at
          world > 1 the parameters within ``F32_PARAM_LIMIT`` (f32) and
          ``F64_PARAM_LIMIT`` (f64 compute) of each tensor's largest
          |value|, the (bf16) latents within 2e-2 of theirs and each
          consistency mean within 0.05 of its own, the bf16 parameters and
          the (bf16) sweep trials printed; the sweep's sampled configs
          equal key for key at every world. One set of files a command;
          rank 0 alone prints; each rank's launches exact (``flash_attention``
          once an SD batch, every other kernel 0); the launcher's exit code
          0, which it gives only when every rank exited 0. The launched
          trains run on the graph route (each rank's step graphs exact:
          one capture, a replay a step after the warm-up ones), the
          commands without a launcher on the eager route (``eager_steps``),
          so that at world 1 the two routes meet bit for bit. First, the
          start-up a rank pays: ``import svtpu_torch.cli`` in a fresh
          process (``import_seconds``), which must not load
          ``torch.distributed.tensor``.
      (b) at world >= 4 only, ``chip_smoke.py --multi-card-worker``: the
          flagship ``Trainer`` (both kernels) on (world,) and (world/2, 2)
          meshes, one f64-compute step's gradients within 1e-5 of each
          tensor's max of the step without a mesh, 2 fused f32 epochs with
          their parameters within ``F32_PARAM_LIMIT``, and two faults on
          the (world,) mesh (the last rank's gradients dropped from the
          all-reduce; the learning rate times the world) beyond it;
          the step graph against the eager route on the (world,) mesh, bit
          for bit on every rank (``routes_agree``: bf16, f32, remat);
          ``PerceptualEncoder`` on a (world,)
          mesh within 2e-2 (bf16) and 1e-5 (f32) of the latents' max; each
          rank's launches exact: the trainers' probes launch
          ``fused_conv01`` and ``lstm_binary_concrete`` as often as the run
          without a mesh, each encode ``flash_attention`` once.
      (d) timings: the flagship step at global batch 32 and the SD encode
          of 16 frames on this card (world 1), and from the worker at
          world N with the gradient all-reduce against its NVLink bound
          and its collective alone, a trace of 5 steps (the card's busy
          share) and NCCL's transports;
          ``flash_attention`` at a rank's share of an SD batch at world 4,
          ``[2, 14080, 512]``.

    Returns the launches of the multi-card path (this process's references
    and timings, and each rank's of the mesh worker), for the kernels
    line."""
    import contextlib
    import io
    import tempfile

    from svtpu_torch import cli
    from svtpu_torch.config import PerceptualConfig, TrainConfig
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.perceptual.convert import PREFIX
    from svtpu_torch.perceptual.embed import (PerceptualEncoder,
                                              load_frame_pm1)
    from svtpu_torch.data.datasets import PairBatcher
    from svtpu_torch.training.checkpoints import BestCheckpointer
    from svtpu_torch.training.step_graph import WARMUP_STEPS
    from svtpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()       # the launched ranks share this card
    world = torch.cuda.device_count()
    print(f"multi card: world {world} (torch.cuda.device_count()), one "
          f"rank a card under python3 -m torch.distributed.run [{card}]")
    startup = import_seconds(card)
    require(startup["dtensor_s"] == 0.0, "multi card: import svtpu_torch.cli "
            "loads torch.distributed.tensor")
    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    meta, splits, ids, states = train_video()
    frames = video_frames(meta, states)
    saved_tf32 = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_jpegs(d / "frames", frames, ids)
        sd_dir = d / "sd_frames"
        write_jpegs(sd_dir, np.random.default_rng(9).integers(
            0, 256, (PERCEP_FRAMES, 720, 1280, 3), np.uint8))
        pcfg = PerceptualConfig()
        decoded = np.stack([load_frame_pm1(str(p), pcfg.resize_wh)
                            for p in sorted(sd_dir.glob("*.jpg"))])
        weights = percep_weights(decoded[:2])
        torch.save({"state_dict": {PREFIX + k: v.cpu()
                                   for k, v in weights["ae"].items()}},
                   d / "sd.ckpt")

        def train_argv(dtype, seed, out):
            return (["train", "--preset", "flagship", "--video",
                     "chinese_chess", "--frames-dir", d / "frames",
                     "--epochs", 2, "--seed", seed, "--save-path", out]
                    + ({"bf16": [], "f32": ["--dtype", "float32"],
                        "f64": ["--dtype", "float64"]}[dtype]))

        def embed_argv(det, out):
            return (["embed", sd_dir, out, "--ckpt", d / "sd.ckpt"]
                    + (["--deterministic"] if det else []))

        # Across cards the batch split reorders the gradient sums, and
        # Adam's scale-free steps carry that into the parameters where a
        # gradient is small (PERF.md §6). At world > 1 the f32 and the f64
        # compute runs each take three seeds, for the spread of that
        # reordering; bf16 rounding moves the parameters by as much as a
        # fault would, so the bf16 run is printed and held to nothing.
        trains = [("bf16", 0), ("f32", 0)] + (
            [("f32", 1), ("f32", 2), ("f64", 0), ("f64", 1), ("f64", 2)]
            if world > 1 else [])
        runs = {f"train_{dt}_s{seed}": (lambda root, dt=dt, seed=seed:
                                        train_argv(dt, seed, root /
                                                   f"train_{dt}_s{seed}"))
                for dt, seed in trains}
        runs["embed"] = lambda root: embed_argv(False, root / "embed.npy")
        runs["embed_det"] = lambda root: embed_argv(True,
                                                    root / "embed_det.npy")
        runs["sweep"] = lambda root: sweep_argv(d / "frames", root / "sweep")
        pckpt = d / "percep_ckpt"
        runs["consistency"] = lambda root: sd_consistency_argv(
            sd_dir, d / "sd.ckpt", pckpt, root / "consistency")

        def want(kind):
            """A command's launches in one process (a rank, or this one):
            ``svtpu``'s defaults leave the pixel kernels off, so only the
            SD first stage's attention runs, once an SD batch (each rank
            encodes its rows of every batch)."""
            w = dict.fromkeys(counters, 0)
            if kind.startswith("embed"):
                w["flash_attention"] = chunks(PERCEP_FRAMES, PERCEP_BATCH)
            elif kind == "consistency":
                w["flash_attention"] = SD_CONSISTENCY_LAUNCHES
            return w

        def deterministic(kind):
            return kind.startswith("train") or kind == "sweep"

        # Every command as ``python3 -m torch.distributed.run --standalone
        # --nproc-per-node <world> -m svtpu_torch.cli ...``, the trains and
        # the sweep with SVTPU_DETERMINISTIC=1, each rank writing its
        # launches (SVTPU_LAUNCHES_DIR), one launch at a time, the first
        # beside the runs without a launcher. Launches side by side failed:
        # on four cards nine of them did not end in 300 s (their ranks
        # time-slice each card, and NCCL's kernels spin on peers that are
        # not scheduled); on one card four of them ran it out of memory.
        run_dir, ref_dir = d / f"world{world}", d / "one"
        run_dir.mkdir()
        ref_dir.mkdir()

        def launch(kind):
            env = {"SVTPU_LAUNCHES_DIR": str(d / "launches" / kind)}
            if deterministic(kind):
                env["SVTPU_DETERMINISTIC"] = "1"
            return Torchrun(world, ["-m", "svtpu_torch.cli",
                                    *runs[kind](run_dir)], d, **env)

        def quiet_cli(argv):
            with warnings.catch_warnings(), \
                    contextlib.redirect_stdout(io.StringIO()):
                warnings.simplefilter("ignore")
                cli.main([str(a) for a in argv])
            torch.cuda.synchronize()

        # A train launch: 2 epochs of global batch 32 on the graph route.
        train_steps = 2 * PairBatcher(
            MemoryStore(frames, ids), splits.train,
            FLAGSHIP_TRAIN["batch_size"]).num_batches()

        def want_graphs(kind):
            if not kind.startswith("train"):
                return {"captures": 0, "replays": 0}
            return {"captures": 1, "replays": train_steps - WARMUP_STEPS}

        t_a = time.perf_counter()
        launched = {k: launch(k) for k in list(runs)[:1]}
        walls, rank_launches, rank_graphs, rank_encodes = {}, {}, {}, {}
        try:
            # The commands without a launcher, in this process meanwhile,
            # under PyTorch's TF32 defaults, as the launched ranks have them.
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False
            graphs_before = step_graph_counts()
            try:
                # On the eager route (its Adam capturable): the launched
                # runs take the graph.
                with eager_steps():
                    # First the percep-flagship checkpoint that both
                    # eval-consistency runs read, on latents made here, as
                    # phase_cli_path makes its own.
                    np.save(d / "latents.npy", percep_latents(ids, states))
                    zero_counts(counters)
                    quiet_cli(["train", "--preset", "percep-flagship",
                               "--video", "chinese_chess", "--embeddings",
                               d / "latents.npy", "--epochs", 1,
                               "--save-path", pckpt])
                    got = read_counts(counters)
                    require(not any(got.values()), f"multi card: train "
                            f"--preset percep-flagship: launches {got}, "
                            f"expected none")
                    for kind, argv in runs.items():
                        if deterministic(kind):
                            os.environ["SVTPU_DETERMINISTIC"] = "1"
                        else:
                            os.environ.pop("SVTPU_DETERMINISTIC", None)
                            torch.use_deterministic_algorithms(False)
                        zero_counts(counters)
                        quiet_cli(argv(ref_dir))
                        got = read_counts(counters)
                        total = add_counts(total, got)
                        require(got == want(kind), f"multi card: {kind} "
                                f"without a launcher: launches {got}, "
                                f"expected {want(kind)}")
            finally:
                os.environ.pop("SVTPU_DETERMINISTIC", None)
                torch.use_deterministic_algorithms(False)
            require(step_graph_counts() == graphs_before, f"multi card: the "
                    f"commands without a launcher replayed step graphs: "
                    f"{step_graph_counts()}, before {graphs_before}")
            torch.cuda.empty_cache()   # the next launches share this card
            names = {fn.__name__: k for k, fn in counters.items()}
            for kind in runs:
                if kind not in launched:
                    launched[kind] = launch(kind)
                rc, out, err, walls[kind] = launched[kind].wait()
                require(rc == 0, f"multi card: python3 -m "
                        f"torch.distributed.run -m svtpu_torch.cli {kind} "
                        f"failed (exit {rc}):\n{out[-3000:]}\n{err[-3000:]}")
                said, n_said = {"train": ("best combined:", 1),
                                "embed": ("saved 16 embeddings", 1),
                                "sweep": ("best best_combined_score:", 1),
                                "consistency": (" ± ", 3)}[
                                    kind.split("_")[0]]
                require(out.count(said) == n_said, f"multi card: the ranks "
                        f"of {kind} printed {out!r}: rank 0 alone prints")
                ranks = [json.loads((d / "launches" / kind /
                                     f"launches_{r}.json").read_text())
                         for r in range(world)]
                rank_launches[kind] = [{names[n]: v for n, v in
                                        r["launches"].items()}
                                       for r in ranks]
                require(all(c == want(kind) for c in rank_launches[kind]),
                        f"multi card: {kind}: the ranks' launches "
                        f"{rank_launches[kind]}, expected {want(kind)} "
                        f"on each")
                require(all(r["flash_attention_by_kernel"]["bf16_d512"]
                            == want(kind)["flash_attention"] for r in ranks),
                        f"multi card: {kind}: attention not on the D = 512 "
                        f"kernel: {ranks}")
                rank_graphs[kind] = [r["step_graphs"] for r in ranks]
                require(kind == "sweep" or all(
                    g == want_graphs(kind) for g in rank_graphs[kind]),
                    f"multi card: {kind}: the ranks' step graphs "
                    f"{rank_graphs[kind]}, expected {want_graphs(kind)} on "
                    f"each")
                rank_encodes[kind] = [r["encode_graphs"] for r in ranks]
                for c in rank_launches[kind]:
                    total = add_counts(total, c)
        finally:
            for t in launched.values():
                t.close()
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved_tf32
        train_kinds = [k for k in runs if k.startswith("train")]
        written = sorted(p.name for p in run_dir.iterdir())
        sweep_files = ["best_model_local_0", "best_model_local_1",
                       "local_0_config.json", "local_1_config.json",
                       "sweep_results.json"]

        def files(root):
            return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_file())

        require(written == sorted(train_kinds + [
                    "consistency", "embed.npy", "embed_det.npy", "sweep"])
                and all(sorted(p.name for p in (run_dir / k).iterdir())
                        == ["best.json", "best.pt", "latest.json",
                            "latest.pt"] for k in train_kinds)
                and sorted(p.name for p in (run_dir / "sweep").iterdir())
                == sweep_files
                and files(run_dir / "sweep") == files(ref_dir / "sweep")
                and "consistency.csv" in files(run_dir / "consistency")
                and files(run_dir / "consistency")
                == files(ref_dir / "consistency"),
                f"multi card: the launched runs wrote {written}; sweep "
                f"{files(run_dir / 'sweep')}, consistency "
                f"{files(run_dir / 'consistency')}")
        print(f"multi card (a): {len(runs)} launches of python3 -m "
              f"torch.distributed.run --standalone --nproc-per-node {world} "
              f"-m svtpu_torch.cli, each exit 0 (every rank exited 0), one "
              f"NCCL group of {world} rank(s) each (NCCL refuses two ranks "
              f"on one card); seconds with start-up, one after another: "
              f"{', '.join(f'{k} {v:.1f}' for k, v in walls.items())} "
              f"({time.perf_counter() - t_a:.1f} s for (a) with the runs "
              f"without a launcher); the ranks' launches "
              f"{ {k: [c['flash_attention'] for c in v] for k, v in rank_launches.items() if want(k)['flash_attention']} }"
              f" (flash_attention, rank by rank; every other kernel 0 on "
              f"every rank of every command); written: {written}, one "
              f"checkpoint directory a train run, one .npy an embed, one "
              f"sweep directory {sweep_files}, one results directory "
              f"{files(run_dir / 'consistency')} [{card}]")
        print(f"multi card (a): each rank's step graphs (captures, replays), "
              f"command by command: "
              f"{ {k: [(g['captures'], g['replays']) for g in v] for k, v in rank_graphs.items()} }"
              f" (a train: {want_graphs('train')} on each rank, its "
              f"{train_steps} steps after {WARMUP_STEPS} eager warm-up "
              f"steps; the commands without a launcher none, on the eager "
              f"route); each rank's encode graphs (captures, replays): "
              f"{ {k: [(g['captures'], g['replays']) for g in v] for k, v in rank_encodes.items()} }"
              f" [{card}]")
        errs, exact, finite, worst = {}, {}, True, {}
        for kind in train_kinds:
            got, _ = BestCheckpointer(run_dir / kind).restore("latest")
            ref, _ = BestCheckpointer(ref_dir / kind).restore("latest")
            rel = rel_errors(got["model"], ref["model"])
            name = max(rel, key=rel.get)
            errs[kind] = rel[name]
            worst[kind] = (f"{name}: max |diff| "
                           f"{float((got['model'][name] - ref['model'][name]).abs().max()):.3e}"
                           f", max |value| "
                           f"{float(ref['model'][name].abs().max()):.3e}")
            exact[kind] = all(torch.equal(got["model"][k], v)
                              for k, v in ref["model"].items())
            finite &= all(bool(torch.isfinite(v).all())
                          for v in got["model"].values())
        for kind in ("embed", "embed_det"):
            got, ref = (np.load(root / f"{kind}.npy", allow_pickle=True)
                        .item() for root in (run_dir, ref_dir))
            require(sorted(got) == sorted(ref) and len(got) == PERCEP_FRAMES,
                    f"multi card: {kind} keys")
            errs[kind] = latent_error(got, ref)
            exact[kind] = errs[kind] == 0.0
        limits = ("0 (bit for bit)" if world == 1 else
                  f"f32 params {F32_PARAM_LIMIT:g}, f64-compute params "
                  f"{F64_PARAM_LIMIT:g}, latents 2e-2 (bf16); bf16 params "
                  f"none")
        print(f"check multi card (a) against the commands without a launcher "
              f"at world {world}: max error / its tensor's max: "
              + "; ".join(f"{k} {errs[k]:.3e} ({worst[k]})"
                          for k in train_kinds)
              + f"; embed stochastic {errs['embed']:.3e}, --deterministic "
              f"{errs['embed_det']:.3e} (limits: {limits}); the runs "
              f"without a launcher and the ranks launched flash_attention "
              f"{total['flash_attention']} times [{card}]")

        # The sweep: the same sampled configs, key for key; every file bit
        # for bit at world 1; at world > 1 its trials (bf16,
        # svtpu_torch/sweeps/runner.py) are printed and held to nothing, as
        # the bf16 train run is.
        trials = []
        for t in range(2):
            got, ref = (json.loads((root / "sweep" /
                                    f"local_{t}_config.json").read_text())
                        for root in (run_dir, ref_dir))
            require(got["config"] == ref["config"], f"multi card: sweep "
                    f"trial {t}'s config {got['config']}, without a "
                    f"launcher {ref['config']}")
            g, r = (BestCheckpointer(root / "sweep" / f"best_model_local_{t}")
                    .restore("latest")[0]["model"]
                    for root in (run_dir, ref_dir))
            rel = rel_errors(g, r)
            name = max(rel, key=rel.get)
            finite &= all(bool(torch.isfinite(v).all()) for v in g.values())
            trials.append(f"trial {t} best_combined_score "
                          f"{got['best_combined_score']:.6f} (without a "
                          f"launcher {ref['best_combined_score']:.6f}), "
                          f"parameters {rel[name]:.3e} ({name})")
        exact["sweep"] = all(
            (run_dir / "sweep" / f).read_bytes()
            == (ref_dir / "sweep" / f).read_bytes()
            for f in files(ref_dir / "sweep"))
        print(f"check multi card (a) sweep --count 2 --epochs 2 at world "
              f"{world} against the run without a launcher: the sampled "
              f"configs equal key for key; " + "; ".join(trials)
              + f"; every file bit for bit: {exact['sweep']} (required at "
              f"world 1 only) [{card}]")

        # eval-consistency --sd-ckpt: the same models and perturbations in
        # the same order; a consistency score is a share in [0, 1].
        rows = [list(csv.DictReader((root / "consistency" /
                                     "consistency.csv").read_text()
                                    .splitlines()))
                for root in (run_dir, ref_dir)]
        keys = [[(r["model"], r["perturbation"]) for r in rs] for rs in rows]
        require(keys[0] == keys[1] and len(keys[1]) == 3, f"multi card: "
                f"eval-consistency rows {keys[0]}, without a launcher "
                f"{keys[1]}")
        diffs = [abs(float(g["mean"]) - float(r["mean"]))
                 for g, r in zip(*rows)]
        exact["consistency"] = all(
            (run_dir / "consistency" / f).read_bytes()
            == (ref_dir / "consistency" / f).read_bytes()
            for f in files(ref_dir / "consistency"))
        print(f"check multi card (a) eval-consistency --sd-ckpt at world "
              f"{world} against the run without a launcher: "
              + "; ".join(f"{g['model']} {g['perturbation']} mean "
                          f"{g['mean']} (|diff| {e:.6f})"
                          for g, e in zip(rows[0], diffs))
              + f" (limit 0.05 at world > 1); consistency.csv bit for bit: "
              f"{exact['consistency']} [{card}]")
        require(finite, "multi card: a launched run's parameters are not "
                "finite")
        if world == 1:
            require(all(exact.values()), f"multi card: not bit for bit at "
                    f"world 1: {exact}")
        else:
            over = {k: e for k, e in errs.items()
                    if e > param_limit(k, latents=2e-2)}
            over.update({f"consistency {g['perturbation']}": e
                         for g, e in zip(rows[0], diffs) if e > 0.05})
            require(not over, f"multi card: beyond the limits at world "
                    f"{world}: {over}")

    # (d) on this card, world 1.
    mcfg = rbvae_variant("contrastive", LATENT, compute_dtype="bfloat16")
    tr = Trainer(mcfg, TrainConfig(**FLAGSHIP_TRAIN),
                 MemoryStore(frames, ids), splits, meta.flags, device="cuda")
    eager_ms, st = flagship_step_ms(tr, graphed=False)
    step_ms, st = flagship_step_ms(tr)
    del tr, st
    enc = PerceptualEncoder(weights["ae"], pcfg, batch_size=PERCEP_BATCH,
                            seed=3)
    embed_s = embed_seconds(enc, decoded)
    _, N, D = PERCEP_ATTN
    q, k, v = attention_inputs(PERCEP_BATCH // 4, N, D, torch.bfloat16, 17)
    attn_ms, attn_sp = cuda_ms(lambda: flash_attention(q, k, v), warmup=3,
                               iters=5)
    flops = 4 * (PERCEP_BATCH // 4) * N * N * D
    attn_bound = max(flops / PEAK_BF16_FLOPS,
                     4 * q.numel() * 2 / PEAK_BYTES) * 1e3
    frames_step = FLAGSHIP_TRAIN["batch_size"] * 2 * 5
    print(f"time: multi card world 1 (this card): flagship train step, "
          f"global batch {FLAGSHIP_TRAIN['batch_size']}, bf16: graph route "
          f"{step_ms:.3f} ms, {frames_step / step_ms * 1e3:.1f} train "
          f"frames/s; eager route {eager_ms:.3f} ms; embed (SD encode, bf16, batches of {PERCEP_BATCH}) of "
          f"{PERCEP_FRAMES} frames at 1280x704: {embed_s:.3f} s, "
          f"{PERCEP_FRAMES / embed_s:.2f} frames/s; flash_attention bf16 "
          f"[{PERCEP_BATCH // 4},{N},{D}] (a rank's share of a batch of "
          f"{PERCEP_BATCH} at world 4): {attn_ms:.3f} ms (spread "
          f"{attn_sp:.3f}), bound {attn_bound:.3f} ms [{card}]")
    result = {"world": world, "step_ms": {1: step_ms},
              "eager_step_ms": {1: eager_ms},
              "embed_fps": {1: PERCEP_FRAMES / embed_s},
              "attn_ms_b2": attn_ms}

    # (b) the Python-API meshes, four cards or more.
    if world < 4:
        print(f"multi card (b): the (4,) and (2, 2) meshes need four cards; "
              f"not run on this machine (world {world}), and nothing is "
              f"claimed for them")
    else:
        mesh = multi_card_meshes(card, world, {
            "step_ms": step_ms, "eager_step_ms": eager_ms,
            "embed_s": embed_s})
        total = add_counts(total, mesh["launches"])
        result["step_ms"][world] = mesh["step_ms"]
        result["eager_step_ms"][world] = mesh["eager_step_ms"]
        result["embed_fps"][world] = mesh["embed_fps"]
    result["launches"] = total
    print(f"multi card: all checks passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {total} [{card}]")
    return result


def attention_library(q, k, v):
    """One PyTorch call computing the same attention, and its backend:
    ``F.scaled_dot_product_attention`` on ``[B, 1, N, D]`` with the first
    backend that takes D = 512 (flash is limited to D <= 256)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(b=backend):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(q4, k4, v4)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    raise AssertionError("no scaled_dot_product_attention backend ran")


def graph_ms(fn, n: int = 50):
    """The device time of one call: ``n`` calls captured in one CUDA graph,
    whose replays are timed with CUDA events, so the host's launch pace
    drops out. Median and spread as ``cuda_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms, spread = cuda_ms(graph.replay, warmup=3, iters=5)
    return ms / n, spread


def instance(symbol: str) -> str:
    """``lstm_binary_concrete_kernel<T, UNITS>``'s template arguments from
    its mangled symbol, e.g. "bf16 x2" (two hidden units a lane)."""
    units = re.search(r"Li(\d)EE", symbol)
    return (f"{'bf16' if 'bfloat16' in symbol else 'f32'} "
            f"x{units.group(1) if units else '?'}")


def phase_kernel_times(card: str, build: dict, main: dict, errs: dict,
                       percep: dict, simple: dict, wide: dict, graphs: dict,
                       train: dict, evaluation: dict, cli: dict,
                       video: dict, rest: dict, multi: dict,
                       clip: dict) -> list:
    """Each kernel's row of the kernels line: its time, its plain
    version's, a library call's where one computes the same function, its
    bound, and its launches on every path of this run (the evaluation,
    command-line, video, rest and multi-card phases' included: the last
    counts every launched rank's)."""
    from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused,
                                               binary_concrete_fused_plain)
    from svtpu_torch.ops.conv_trunk_cuda import (fused_conv01,
                                                 fused_conv01_plain)
    from svtpu_torch.ops.lstm_cuda import (lstm_binary_concrete,
                                           lstm_binary_concrete_plain)

    def eval_launches(name):
        return sum(d[name] for d in evaluation.values())

    rows = []
    x, w0, b0, w1, b1 = trunk_inputs(BATCH, 2)
    xb = x.to(torch.bfloat16)
    ms, sp = cuda_ms(lambda: fused_conv01(xb, w0, b0, w1, b1))
    plain_ms, _ = cuda_ms(lambda: fused_conv01_plain(xb, w0, b0, w1, b1),
                          iters=3)
    # Library yardstick: cuDNN conv x2 with ReLU, bf16, channels-last.
    xl = xb.permute(0, 3, 1, 2)
    w0b, w1b = (w.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for w in (w0, w1))
    b0b, b1b = b0.to(torch.bfloat16), b1.to(torch.bfloat16)
    lib_ms, _ = cuda_ms(lambda: F.conv2d(
        F.conv2d(xl, w0b, b0b, 2, 1).relu(), w1b, b1b, 2, 1).relu())
    flops = 2 * BATCH * (128 * 128 * 64 * 27 + 64 * 64 * 64 * 576)
    nbytes = 2 * (BATCH * (256 * 256 * 3 + 64 * 64 * 64)
                  + 64 * 27 + 64 * 576 + 64) + 4 * 64
    bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    rows.append(dict(
        name="fused_conv01", route="cuda",
        source="svtpu_torch/csrc/fused_conv01.cu",
        replaces="svtpu/ops/conv_trunk_pallas.py:106",
        launches=sum(d["launches"]["fused_conv01"]
                     for d in (main, wide, graphs, train, cli, video, rest,
                               multi))
        + eval_launches("fused_conv01"),
        max_abs_err=errs["fused_conv01"]["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=lib_ms))
    print(f"time: fused_conv01 bf16 B={BATCH}: kernel {ms:.3f} ms (spread "
          f"{sp:.3f}, {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{max(bound.values()) / ms:.1%} of bound), plain {plain_ms:.3f} "
          f"ms, cuDNN conv x2 {lib_ms:.3f} ms (kernel "
          f"{'faster' if ms < lib_ms else 'SLOWER'}), bound "
          f"{max(bound.values()):.3f} ms ({max(bound, key=bound.get)}), "
          f"launches per encode {main['per_encode']['fused_conv01']:.0f} "
          f"(pixel {main['launches']['fused_conv01']}, wide latent "
          f"{wide['launches']['fused_conv01']}, graph routes "
          f"{graphs['launches']['fused_conv01']}, train probes "
          f"{train['launches']['fused_conv01']}, evaluation "
          f"{eval_launches('fused_conv01')}, cli "
          f"{cli['launches']['fused_conv01']}, video "
          f"{video['launches']['fused_conv01']}, rest "
          f"{rest['launches']['fused_conv01']}, multi card "
          f"{multi['launches']['fused_conv01']}) [{card}]")

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(BATCH, 1, LATENT, generator=g).cuda() \
        .to(torch.bfloat16)
    seed = torch.tensor([9], device="cuda")
    sample = lambda: binary_concrete_fused(  # noqa: E731
        logits, seed, TEMPERATURE, 0.1)
    ms, sp = cuda_ms(sample, iters=50)
    dev_ms, dev_sp = graph_ms(sample)
    # The temperature and noise scale read from the card, as the encode
    # graphs launch it.
    temp_t = torch.tensor(TEMPERATURE, dtype=torch.float32, device="cuda")
    scale_t = torch.tensor(0.1, dtype=torch.float32, device="cuda")
    ptr_ms, ptr_sp = graph_ms(lambda: binary_concrete_fused(
        logits, seed, temp_t, scale_t))
    plain_ms, _ = cuda_ms(lambda: binary_concrete_fused_plain(
        logits, 9, TEMPERATURE, 0.1), iters=20)
    n = logits.numel()
    # ~40 operations an element: Philox's share, the 24-bit u, two logs,
    # the noise, the tempered sigmoid and the threshold.
    bound = {"operations": 40 * n / PEAK_F32_FLOPS * 1e3,
             "bytes": 2 * 2 * n / PEAK_BYTES * 1e3}
    launches = {k: d["launches"]["binary_concrete"] for k, d in
                (("pixel", main), ("percep", percep), ("simple", simple),
                 ("wide", wide), ("graph routes", graphs), ("cli", cli),
                 ("video", video), ("rest", rest), ("multi card", multi))}
    launches["evaluation"] = eval_launches("binary_concrete")
    rows.append(dict(
        name="binary_concrete", route="cuda",
        source="svtpu_torch/csrc/binary_concrete.cu",
        replaces="svtpu/ops/binarize_pallas.py:25",
        launches=sum(launches.values()),
        max_abs_err=errs["binary_concrete"]["max_abs_err"], ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=None))
    print(f"time: binary_concrete bf16 [{BATCH},1,{LATENT}] noisy hard, seed "
          f"tensor on the card: wrapper {ms:.4f} ms (50 back-to-back calls, "
          f"spread {sp:.3f}), device {dev_ms:.4f} ms (a CUDA graph of 50 "
          f"launches, spread {dev_sp:.3f}; the temperature and noise scale "
          f"read from the card {ptr_ms:.4f} ms, spread {ptr_sp:.3f}), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{max(bound.values()):.2e} ms ({max(bound, key=bound.get)}), "
          f"library none, launches by path {launches} [{card}]")

    # The fused encoder LSTM + sampler at the pixel path's shape: the
    # flagship's 2-layer LSTM (seeded weights), [512, 1, 25] bf16.
    layers = 2
    lstm = seeded_lstm(LATENT, layers, False, torch.bfloat16, 50)
    fused = lambda: lstm_binary_concrete(  # noqa: E731
        lstm, logits, seed, TEMPERATURE, 0.1)
    with torch.inference_mode():
        ms, sp = cuda_ms(fused, iters=50)
        dev_ms, dev_sp = graph_ms(fused)
        ptr_ms, ptr_sp = graph_ms(lambda: lstm_binary_concrete(
            lstm, logits, seed, temp_t, scale_t))
        plain_ms, _ = cuda_ms(lambda: lstm_binary_concrete_plain(
            lstm, logits, 9, TEMPERATURE, 0.1), iters=20)
        # Library yardstick: nn.LSTM's forward alone (no sampler), in the
        # first dtype cuDNN takes.
        ref = torch.nn.LSTM(LATENT, LATENT, layers, batch_first=True).cuda()
        ref.load_state_dict(lstm.lstm.state_dict())
        lib_dt = next(dt for dt in (torch.bfloat16, torch.float32)
                      if torch.backends.cudnn.is_acceptable(logits.to(dt)))
        ref, x_lib = ref.to(lib_dt), logits.to(lib_dt)
        lib_ms, _ = cuda_ms(lambda: ref(x_lib), iters=20)
    B, T, H = logits.shape
    w_bytes = layers * (2 * 4 * H * H + 2 * 4 * H) * 4
    # Per layer and (row, step): both gate products, 2 * 4H * 2H, and ~20
    # operations a hidden unit for the gates, c and h; then ~40 an element
    # for the sampler, as binary_concrete's row counts.
    ops = layers * B * T * (2 * 4 * H * 2 * H + 20 * H) + 40 * B * T * H
    bound = {"operations": ops / PEAK_F32_FLOPS * 1e3,
             "bytes": (2 * 2 * B * T * H + w_bytes) / PEAK_BYTES * 1e3}
    usage = {fn: r for fn, r in build.items()
             if "lstm_binary_concrete_kernel" in fn}
    launches = {k: d["launches"]["lstm_binary_concrete"] for k, d in
                (("pixel", main), ("percep", percep),
                 ("graph routes", graphs), ("train", train), ("cli", cli),
                 ("video", video), ("rest", rest), ("multi card", multi))}
    launches["percep train"] = \
        train["percep_launches"]["lstm_binary_concrete"]
    launches["evaluation"] = eval_launches("lstm_binary_concrete")
    rows.append(dict(
        name="lstm_binary_concrete", route="cuda",
        source="svtpu_torch/csrc/lstm_binary_concrete.cu",
        replaces="svtpu/ops/binarize_pallas.py:25",
        launches=sum(launches.values()),
        max_abs_err=errs["lstm_binary_concrete"]["max_abs_err"], ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=lib_ms,
        library=f"nn.LSTM forward alone, no sampler, "
                f"{str(lib_dt).split('.')[-1]} (cuDNN)",
        registers={fn: r.get("registers") for fn, r in usage.items()},
        spill_bytes=sum(r.get("spill_bytes", 0) for r in usage.values())))
    print(f"time: lstm_binary_concrete bf16 [{B},{T},{H}], {layers} layers, "
          f"noisy hard, seed tensor on the card: wrapper {ms:.4f} ms (50 "
          f"back-to-back calls, spread {sp:.3f}), device {dev_ms:.4f} ms (a "
          f"CUDA graph of 50 launches, spread {dev_sp:.3f}; the "
          f"temperature and noise scale read from the card {ptr_ms:.4f} "
          f"ms, spread {ptr_sp:.3f}), plain "
          f"{plain_ms:.4f} ms (the port's LSTM + binary_concrete_fused_plain)"
          f", nn.LSTM forward alone in {lib_dt} (cuDNN, no sampler) "
          f"{lib_ms:.4f} ms, bound {max(bound.values()):.2e} ms "
          f"({max(bound, key=bound.get)}: {ops / 1e6:.2f} MFLOP, "
          f"{(2 * 2 * B * T * H + w_bytes) / 1e3:.1f} KB), launches by path "
          f"{launches}; registers "
          f"{ {instance(fn): r.get('registers') for fn, r in usage.items()} }"
          f", "
          f"spill bytes {rows[-1]['spill_bytes']} [{card}]")

    att = errs["flash_attention"]
    rows.append(attention_row(
        card, build, "flash_attention", "flash_d512_kernel", PERCEP_ATTN, 17,
        {"percep": percep["launches"]["flash_attention"],
         "graph routes": graphs["launches"]["flash_attention"],
         "evaluation": eval_launches("flash_attention"),
         "cli": cli["launches"]["flash_attention"],
         "video": video["launches"]["flash_attention"],
         "rest": rest["launches"]["flash_attention"],
         "multi card": multi["launches"]["flash_attention"]},
        att["max_abs_err"], ms_2x14080x512=multi["attn_ms_b2"]))
    rows.append(attention_row(
        card, build, "flash_attention_d64", "flash_bf16_kernel", VIT_ATTN, 23,
        {"clip": clip["launches"]["bf16_d64"]}, att["max_abs_err_d64"],
        device_n=20))
    return rows


def attention_row(card: str, build: dict, name: str, symbol: str,
                  shape: tuple, seed: int, launches: dict, err: float,
                  device_n: int = 0, **extra) -> dict:
    """The kernels line's row of ``flash_attention`` at bf16 ``shape``, the
    kernel whose symbol holds ``symbol``: its time, its plain version's,
    ``scaled_dot_product_attention``'s as the yardstick only, its bound
    (4·B·N²·D operations; q, k, v and the output once), its registers, and
    ``launches`` by path. With ``device_n``, also the device time of one
    launch in a CUDA graph of ``device_n``."""
    from svtpu_torch.ops.attention import blocked_attention, flash_attention

    B, N, D = shape
    q, k, v = attention_inputs(B, N, D, torch.bfloat16, seed)
    ms, sp = cuda_ms(lambda: flash_attention(q, k, v), warmup=3, iters=3)
    plain_ms, _ = cuda_ms(lambda: blocked_attention(q, k, v), warmup=2,
                          trials=3, iters=2)
    lib, backend = attention_library(q, k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lib_ms, _ = cuda_ms(lib, warmup=3, iters=3)
    flops = 4 * B * N * N * D
    bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "bytes": 4 * B * N * D * 2 / PEAK_BYTES * 1e3}
    (usage,) = [r for fn, r in build.items() if symbol in fn]
    row = dict(
        name=name, route="cuda", source="svtpu_torch/csrc/flash_attention.cu",
        replaces="svtpu/ops/attention.py:26", launches=sum(launches.values()),
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bound.values()), bound_by=max(bound, key=bound.get),
        library_ms=lib_ms, registers=usage.get("registers"), **extra)
    device = ""
    if device_n:
        row["device_ms"], dev_sp = graph_ms(lambda: flash_attention(q, k, v),
                                            n=device_n)
        device = (f", device {row['device_ms']:.3f} ms (a CUDA graph of "
                  f"{device_n} launches, spread {dev_sp:.3f})")
    print(f"time: flash_attention bf16 [{B},{N},{D}] ({symbol}): kernel "
          f"{ms:.3f} ms (spread {sp:.3f}, {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{max(bound.values()) / ms:.1%} of bound){device}, plain "
          f"{plain_ms:.3f} ms, scaled_dot_product_attention ({backend}, the "
          f"yardstick only) {lib_ms:.3f} ms (kernel "
          f"{'faster' if ms < lib_ms else 'SLOWER'}), bound "
          f"{max(bound.values()):.3f} ms ({max(bound, key=bound.get)}: "
          f"{flops / 1e9:.1f} GFLOP), launches by path {launches}; "
          f"registers {usage.get('registers')} at launch [{card}]")
    return row


def main() -> None:
    # Deterministic cuBLAS for the training check; read when cuBLAS starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_toolchain()
    build = phase_build()
    errs = {"fused_conv01": phase_conv_kernel(),
            "binary_concrete": phase_sampler_kernel(),
            "lstm_binary_concrete": phase_lstm_kernel(),
            "flash_attention": phase_attention_kernel()}
    group_norm = phase_group_norm_kernel(card, build)
    main_path = phase_main_path(card)
    simple = phase_simple_path(card)
    wide = phase_wide_path(card)
    percep = phase_percep_path(card)
    clip = phase_clip_path(card)
    phase_sam2_path(card)
    graphs = phase_encode_graphs(card, percep.pop("weights"))
    train = phase_train_path(card)
    evaluation = phase_eval_path(card)
    cli = phase_cli_path(card)
    video = phase_video_path(card)
    rest = phase_rest_path(card)
    multi = phase_multi_card(card)
    rows = phase_kernel_times(card, build, main_path, errs, percep, simple,
                              wide, graphs, train, evaluation, cli, video,
                              rest, multi, clip)
    for row in rows:
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print("before the redesign (constants from PERF.md §6, not measured "
          "here): " + ", ".join(
              f"{r['name']} {PREV_MS[r['name']]} ms, now {r['ms']:.4f} ms"
              for r in rows))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows, "group_norm_silu": {
        k: group_norm[k] for k in ("shapes", "batch")}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-card-worker"]:
        multi_card_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--capture-failure"]:
        capture_failure_worker()
    elif sys.argv[1:2] == ["--encode-capture-failure"]:
        encode_capture_failure_worker()
    else:
        main()
