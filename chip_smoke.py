#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``svtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``svtpu_torch/csrc`` (into ``build/``),
holds each against its plain PyTorch version, drives the flagship encode
path — the committed contrastive RBVAE (``results/p_hardened_params.npz``,
latent 25, bf16, 256x256 RGB, batch 512) through
``VideoSymbolPipeline.run_frames`` with both kernels switched on — and times
the encode and each kernel beside its plain version, a library call and its
bound. Every check that fails raises, so the exit code is non-zero; the last
line of standard output is ``{"ok": true, "device": {...}}`` only when every
phase passed. Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 512
LATENT = 25
TEMPERATURE = 0.2
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def phase_build() -> None:
    from svtpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s (rebuilt: {sorted(logs)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                print(f"  {name}: {line.strip()}")


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
    """fused_conv01 vs its plain version: at B=8 f32 held to 1e-3 with TF32
    off and bf16 reported; at the main path's shape (B=512, bf16) held to
    two bf16 steps at the output's scale, since the two sum conv0 in
    another order and a conv0 value can round to a neighbouring bf16."""
    e32, _ = conv_error(8, torch.float32, 0)
    e16, _ = conv_error(8, torch.bfloat16, 0)
    emain, step = conv_error(BATCH, torch.bfloat16, 1)
    print(f"check fused_conv01 vs plain: B=8 f32 max_abs_err {e32:.3e} "
          f"(limit 1e-3), B=8 bf16 max_abs_err {e16:.3e} (reported); "
          f"B={BATCH} bf16 max_abs_err {emain:.3e} (limit {2 * step:.3e}, "
          f"two bf16 steps at the output's scale)")
    require(e32 < 1e-3, "fused_conv01 f32 disagrees")
    require(emain <= 2 * step, "fused_conv01 bf16 at the main path's shape "
            "disagrees")
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
    from svtpu_torch.ops.conv_trunk_cuda import fused_conv01
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
            "fused_conv01 kernel": lambda: fused_conv01(
                xb, c0.weight, c0.bias, c1.weight, c1.bias),
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


def phase_kernel_times(card: str, main: dict, errs: dict) -> list:
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
          f"{sp:.3f}, {flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} "
          f"ms, cuDNN conv x2 {lib_ms:.3f} ms, bound {max(bound.values()):.3f}"
          f" ms ({max(bound, key=bound.get)}), launches per encode "
          f"{main['per_encode']['fused_conv01']:.0f} [{card}]")

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
        launches=main["launches"]["binary_concrete"],
        max_abs_err=errs["binary_concrete"]["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bound.values()),
        bound_by=max(bound, key=bound.get), library_ms=None))
    print(f"time: binary_concrete bf16 [{BATCH},1,{LATENT}] noisy hard: "
          f"kernel {ms:.4f} ms (spread {sp:.3f}), plain {plain_ms:.4f} ms, "
          f"bound {max(bound.values()):.2e} ms ({max(bound, key=bound.get)})"
          f", library none, launches per encode "
          f"{main['per_encode']['binary_concrete']:.0f} [{card}]")
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
            "binary_concrete": phase_sampler_kernel()}
    main_path = phase_main_path(card)
    rows = phase_kernel_times(card, main_path, errs)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
