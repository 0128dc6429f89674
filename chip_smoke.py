#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``svtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``svtpu_torch/csrc`` (into ``build/``),
prints each kernel's registers, spills and tensor-core instruction counts
(HMMA for mma.sync, HGMMA for wgmma, from ``cuobjdump --dump-sass``), and
holds each kernel against its plain PyTorch version, ``fused_conv01`` also
at B = 1, 7 and 133 and ``flash_attention`` on every kernel its launcher
dispatches to. Then it drives two paths
through ``VideoSymbolPipeline.run_frames``, each with its kernels switched
on and their launches counted:

  * the pixel path: the committed contrastive RBVAE
    (``results/p_hardened_params.npz``, latent 25, bf16, 256x256 RGB,
    batch 512) through ``fused_conv01`` and ``binary_concrete``;
  * the perceptual path: the SD first stage at its published widths
    (``PerceptualConfig()``, bf16, seeded random weights) in
    ``PerceptualEncoder`` batches of 8 through ``flash_attention``, then the
    ``percep-flagship`` RBVAE (latent 25, LSTM residual) through
    ``binary_concrete``, on 16 seeded 720x1280 frames; and one
    ``decode_latents`` (the decoder's attention).

Each path's deterministic codes are held against its plain path's, and the
paths and every kernel are timed beside the plain version, a library call
and the kernel's bound. Every check that fails raises, so the exit code is
non-zero; the last line of standard output is ``{"ok": true, "device":
{...}}`` only when every phase passed. Needs one CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import json
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
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The bf16 kernels meant for the tensor cores (substrings of their symbols).
TENSOR_CORE_KERNELS = ("fused_conv01_tc", "flash_d512_kernel",
                       "flash_bf16_kernel")
# Each kernel's time before its redesign for Hopper (PERF.md §6, NVIDIA
# H100 80GB HBM3, 700.00 W): constants, printed on a line of their own
# beside this run's times and kept out of the kernels line.
PREV_MS = {"fused_conv01": 10.507, "binary_concrete": 0.0302,
           "flash_attention": 32.464}


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


def phase_build() -> None:
    """Build every kernel; print each kernel's registers, spills and
    tensor-core instruction counts. A bf16 tensor-core kernel with no HMMA
    or HGMMA instruction, or with spills, fails the run."""
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
        require(r.get("spill_bytes", 0) == 0, f"{key}: ptxas spills")


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
          f"{differs}; logits +8 p(1) {big:.4f} (> 0.95)")
    require(err <= 2.0 ** -8, "sampler noisy soft values disagree")
    require(noisy_mismatch < 1e-3, "sampler noisy: disagrees with Philox")
    require(0.45 < p_one < 0.55, "sampler: p(1) at zero logits")
    require(same and differs, "sampler: seed determinism")
    require(big > 0.95, "sampler: monotonicity")
    return {"max_abs_err": err}


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
    D = 512 kernel, those at D = 64 and 96 the first bf16 kernel."""
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
    return {"max_abs_err": out[f"[{B},{N},{D}] bf16 spread 8"]}


def flagship(pallas: bool, dtype: str = "bfloat16"):
    from svtpu_torch.config import rbvae_variant
    from svtpu_torch.models.convert import from_jax_params, load_params_npz

    cfg = rbvae_variant("contrastive", LATENT, compute_dtype=dtype,
                        pallas_trunk=pallas, pallas_sampler=pallas)
    tree = load_params_npz(ROOT / "results" / "p_hardened_params.npz")
    return cfg, from_jax_params(tree, cfg)


def phase_main_path(card: str) -> dict:
    """The flagship encode through both kernels, counted; then the kernel
    path's deterministic codes against the plain path's."""
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.pipeline import VideoSymbolPipeline

    rng = np.random.default_rng(0)
    frames = {"256x256": rng.integers(0, 256, (BATCH, 256, 256, 3), np.uint8),
              "432x768": rng.integers(0, 256, (BATCH, 432, 768, 3), np.uint8)}
    cfg, sd = flagship(True)
    pipe = VideoSymbolPipeline(cfg, sd)

    counters = (fused_conv01, binary_concrete_fused)
    for fn in counters:
        fn.launches = 0
    codes = {k: pipe.run_frames(v, i) for i, (k, v) in
             enumerate(frames.items())}
    torch.cuda.synchronize()
    launches = {"fused_conv01": fused_conv01.launches,
                "binary_concrete": binary_concrete_fused.launches}
    print(f"main path: run_frames x{len(frames)} ({', '.join(frames)}), "
          f"batch {BATCH}, noise on; launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"main path never launched {name}")
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
    with torch.inference_mode():
        ms, spread = cuda_ms(lambda: pipe.model.encode(
            xd, TEMPERATURE, True, 0.1, generator=gen), iters=5)
    print(f"time: model.encode on the card (f32 frames on the card), batch "
          f"{BATCH}: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} frames/s, spread "
          f"{spread:.3f} [{card}]")
    phase_breakdown(card, pipe, frames, xd)
    return {"launches": launches, "per_encode": {
        k: n / len(frames) for k, n in launches.items()}}


def phase_breakdown(card: str, pipe, frames: dict, xd) -> None:
    """Where one batch's time goes: each stage of run_frames alone, on the
    input the main path gives it, timed with CUDA events."""
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01, kernel_weights
    from svtpu_torch.ops.image import resize_bilinear, to_float01

    m, dt = pipe.model, pipe.cfg.torch_dtype
    enc = m.encoder_cnn
    c0, c1, c2 = enc.convs()
    with torch.inference_mode():
        u8 = {k: torch.from_numpy(v) for k, v in frames.items()}
        u8_dev = u8["432x768"].cuda()
        xb = xd[:, 0].to(dt)
        h01 = fused_conv01(xb, c0.weight, c0.bias, c1.weight, c1.bias)
        h2 = c2(h01.permute(0, 3, 1, 2), dt)
        logits = enc.fc(h2.reshape(BATCH, -1), dt)[:, None]
        h_seq = m.encoder_rnn(logits)
        stages = {
            "copy 256x256 uint8 frames to the card":
                lambda: u8["256x256"].cuda(),
            "to_float01 + resize 432x768 -> 256x256":
                lambda: resize_bilinear(to_float01(u8_dev), (256, 256)),
            "cast frames to bf16": lambda: xd[:, 0].to(dt),
            "fused_conv01 kernel (its wrapper, packing included)":
                lambda: fused_conv01(xb, c0.weight, c0.bias, c1.weight,
                                     c1.bias),
            "  of which packing the weights (kernel_weights)":
                lambda: kernel_weights(dt, c0.weight, c0.bias, c1.weight,
                                       c1.bias),
            "conv2 (cuDNN)": lambda: c2(h01.permute(0, 3, 1, 2), dt),
            "fc 65536 -> 25": lambda: enc.fc(h2.reshape(BATCH, -1), dt),
            "encoder LSTM, 2 layers": lambda: m.encoder_rnn(logits),
            "binary_concrete kernel": lambda: binary_concrete_fused(
                h_seq, 5, TEMPERATURE, 0.1),
        }
        for name, fn in stages.items():
            ms, spread = cuda_ms(fn, iters=5)
            print(f"time: stage {name}, batch {BATCH}: {ms:.4f} ms, spread "
                  f"{spread:.3f} [{card}]")


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
    ``run_frames`` (host resize to 1280x704, SD encode in batches of 8 with
    the attention kernel, percep RBVAE encode with the sampler kernel),
    then one ``decode_latents`` (the decoder's attention). Launches counted;
    then the kernel path against the plain path, deterministic."""
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.binarize_cuda import binary_concrete_fused
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
    from svtpu_torch.ops.image import resize_u8

    t0 = time.perf_counter()
    frames = np.random.default_rng(7).integers(
        0, 256, (PERCEP_FRAMES, 720, 1280, 3), np.uint8)
    weights = percep_weights(frames[:2, :704])
    pipe = percep_pipeline(weights, True)
    print(f"percep path: weights and pipeline built in "
          f"{time.perf_counter() - t0:.1f} s")

    counters = (flash_attention, binary_concrete_fused, fused_conv01)
    for fn in counters:
        fn.launches = 0
    by_kernel = flash_attention.launches_by_kernel
    for name in by_kernel:
        by_kernel[name] = 0
    torch.cuda.reset_peak_memory_stats()
    codes = pipe.run_frames(frames, 0)
    z = pipe.percep.encode_frames(frames[:2, :704])
    pixels = pipe.percep.decode_latents(z)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "binary_concrete": binary_concrete_fused.launches,
                "fused_conv01": fused_conv01.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"percep path: run_frames x1 ({PERCEP_FRAMES} frames 720x1280, SD "
          f"batch {PERCEP_BATCH}, noise on) + encode_frames x1 (2 frames) + "
          f"decode_latents x1 (2 latents); launches {launches}, "
          f"flash_attention by kernel {dict(by_kernel)}; peak device "
          f"memory {peak:.2f} GiB")
    for name in ("flash_attention", "binary_concrete"):
        require(launches[name] > 0, f"percep path never launched {name}")
    require(by_kernel["bf16_d512"] == launches["flash_attention"],
            "percep path: attention not on the D = 512 kernel")
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

    # The slice against its plain path: AE at its mode, noise off.
    sd_frames = resize_u8(torch.from_numpy(frames), (704, 1280)).numpy()
    agree, rel = {}, {}
    for dtype, n in (("bfloat16", PERCEP_FRAMES), ("float32", 4)):
        det = {k: percep_pipeline(weights, k, dtype, deterministic=True)
               for k in (True, False)}
        lat = {k: p.percep.encode_frames(sd_frames[:n]) for k, p in
               det.items()}
        rel[dtype] = float(np.abs(lat[True] - lat[False]).max()
                           / np.abs(lat[False]).max())
        c = {k: p.run_frames(frames[:n]) for k, p in det.items()}
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
    phase_percep_breakdown(card, pipe, frames, batch)
    return {"launches": launches, "fps": med, "encode_ms": med_enc}


def phase_percep_breakdown(card: str, pipe, frames, batch) -> None:
    """Where one SD batch's time goes: each stage of encode_frames and the
    RBVAE encode alone, on the input the path gives it, CUDA events; the
    host resize on the host clock."""
    from svtpu_torch.models.autoencoder_kl import DiagonalGaussian
    from svtpu_torch.ops.attention import flash_attention
    from svtpu_torch.ops.image import resize_u8

    host = torch.from_numpy(frames)
    t0 = time.perf_counter()
    for _ in range(3):
        resize_u8(host, (704, 1280))
    print(f"time: stage host resize {PERCEP_FRAMES} uint8 720x1280 -> "
          f"1280x704 (CPU): {(time.perf_counter() - t0) / 3 * 1e3:.3f} ms "
          f"[{card}]")
    model = pipe.percep.model
    enc, dt = model.encoder, model.cfg.torch_dtype
    u8 = torch.from_numpy(batch)
    stages = {}
    with torch.inference_mode():
        x = u8.cuda().float() * (2.0 / 255.0) - 1.0
        stages[f"copy {PERCEP_BATCH} uint8 1280x704 frames to the card"] = \
            lambda: u8.cuda()
        h = x.permute(0, 3, 1, 2)
        stages["encoder conv_in"] = (lambda a: enc.conv_in(a, dt), h)
        h = enc.conv_in(h, dt)

        def level(lv):
            def run(a):
                for block in lv.block:
                    a = block(a, dt)
                return lv.downsample(a, dt) if hasattr(lv, "downsample") \
                    else a
            return run
        for i, lv in enumerate(enc.down):
            fn = level(lv)
            stages[f"encoder level {i} ({tuple(h.shape[1:])})"] = (fn, h)
            if i == 0:
                block = lv.block[0]
                stages["  of which one GroupNorm+SiLU (f32, then bf16)"] = (
                    lambda a: block.norm1(a, dt), h)
                stages["  of which one conv 128->128 k3 (cuDNN)"] = (
                    lambda a: block.conv1(a, dt), block.norm1(h, dt))
            h = fn(h)
        mid = enc.mid
        stages["encoder mid.block_1"] = (lambda a: mid.block_1(a, dt), h)
        h = mid.block_1(h, dt)
        stages["encoder mid.attn_1 (norm, q/k/v, kernel, proj_out)"] = (
            lambda a: mid.attn_1(a, dt), h)
        qkv = [m(mid.attn_1.norm(h, dt), dt).flatten(2).transpose(1, 2)
               .contiguous() for m in (mid.attn_1.q, mid.attn_1.k,
                                       mid.attn_1.v)]
        stages["  of which the flash_attention kernel"] = (
            lambda a: flash_attention(*a), qkv)
        h = mid.attn_1(h, dt)
        stages["encoder mid.block_2"] = (lambda a: mid.block_2(a, dt), h)
        h = mid.block_2(h, dt)
        stages["encoder norm_out + conv_out"] = (
            lambda a: enc.conv_out(enc.norm_out(a, dt), dt), h)
        h = enc.conv_out(enc.norm_out(h, dt), dt)
        stages["quant_conv + posterior mode + scale"] = (
            lambda a: model.cfg.scale_factor * DiagonalGaussian.from_moments(
                model.quant_conv(a, dt).permute(0, 2, 3, 1)).mode(), h)
        lat = torch.randn(PERCEP_FRAMES, 1, 88, 160, 4, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(3)
        stages[f"percep RBVAE encode ({PERCEP_FRAMES} frames)"] = (
            lambda a: pipe.model.encode(a, TEMPERATURE, True, 0.1,
                                        generator=gen), lat)
        for name, st in stages.items():
            fn, arg = (st, None) if callable(st) else st
            call = fn if arg is None else (lambda f=fn, a=arg: f(a))
            ms, spread = cuda_ms(call, warmup=2, trials=3, iters=2)
            print(f"time: stage {name}, batch {PERCEP_BATCH}: {ms:.4f} ms, "
                  f"spread {spread:.3f} [{card}]")


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


def phase_kernel_times(card: str, main: dict, errs: dict,
                       percep: dict) -> list:
    from svtpu_torch.ops.binarize_cuda import (binary_concrete_fused,
                                               binary_concrete_fused_plain)
    from svtpu_torch.ops.conv_trunk_cuda import (fused_conv01,
                                                 fused_conv01_plain)

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
        launches=main["launches"]["fused_conv01"],
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
          f"[{card}]")

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(BATCH, 1, LATENT, generator=g).cuda() \
        .to(torch.bfloat16)
    ms, sp = cuda_ms(lambda: binary_concrete_fused(logits, 9, TEMPERATURE,
                                                   0.1), iters=50)
    plain_ms, _ = cuda_ms(lambda: binary_concrete_fused_plain(
        logits, 9, TEMPERATURE, 0.1), iters=20)
    n = logits.numel()
    # ~40 operations an element: Philox's share, the 24-bit u, two logs,
    # the noise, the tempered sigmoid and the threshold.
    bound = {"operations": 40 * n / PEAK_F32_FLOPS * 1e3,
             "bytes": 2 * 2 * n / PEAK_BYTES * 1e3}
    rows.append(dict(
        name="binary_concrete", route="cuda",
        source="svtpu_torch/csrc/binary_concrete.cu",
        replaces="svtpu/ops/binarize_pallas.py:25",
        launches=(main["launches"]["binary_concrete"]
                  + percep["launches"]["binary_concrete"]),
        max_abs_err=errs["binary_concrete"]["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=None))
    print(f"time: binary_concrete bf16 [{BATCH},1,{LATENT}] noisy hard: "
          f"kernel {ms:.4f} ms (spread {sp:.3f}), plain {plain_ms:.4f} ms, "
          f"bound {max(bound.values()):.2e} ms ({max(bound, key=bound.get)})"
          f", library none, launches per encode "
          f"{main['per_encode']['binary_concrete']:.0f}, on the percep path "
          f"{percep['launches']['binary_concrete']} [{card}]")

    from svtpu_torch.ops.attention import blocked_attention, flash_attention

    B, N, D = PERCEP_ATTN
    q, k, v = attention_inputs(B, N, D, torch.bfloat16, 17)
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
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="svtpu_torch/csrc/flash_attention.cu",
        replaces="svtpu/ops/attention.py:26",
        launches=percep["launches"]["flash_attention"],
        max_abs_err=errs["flash_attention"]["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=lib_ms))
    print(f"time: flash_attention bf16 [{B},{N},{D}]: kernel {ms:.3f} ms "
          f"(spread {sp:.3f}, {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{max(bound.values()) / ms:.1%} of bound), plain "
          f"{plain_ms:.3f} ms, scaled_dot_product_attention ({backend}) "
          f"{lib_ms:.3f} ms (kernel {'faster' if ms < lib_ms else 'SLOWER'})"
          f", bound {max(bound.values()):.3f} ms "
          f"({max(bound, key=bound.get)}: {flops / 1e12:.3f} TFLOP), "
          f"launches on the percep path "
          f"{percep['launches']['flash_attention']} [{card}]")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_toolchain()
    phase_build()
    errs = {"fused_conv01": phase_conv_kernel(),
            "binary_concrete": phase_sampler_kernel(),
            "flash_attention": phase_attention_kernel()}
    main_path = phase_main_path(card)
    percep = phase_percep_path(card)
    rows = phase_kernel_times(card, main_path, errs, percep)
    for row in rows:
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print("before the redesign (constants from PERF.md §6, not measured "
          "here): " + ", ".join(
              f"{r['name']} {PREV_MS[r['name']]} ms, now {r['ms']:.4f} ms"
              for r in rows))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
