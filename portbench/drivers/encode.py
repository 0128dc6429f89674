"""Encode cells: a closed loop of one client sending frame batches through
``VideoSymbolPipeline.run_frames``, the library's serving entry.

Traffic (the workload file's ``traffic``): ``batches`` distinct batches of
``batch`` seeded uint8 frames of ``frame_hw``, made in set-up in pageable
host memory and sent in turn; request ``i`` is ``run_frames(batch i mod
batches, batch_index=i)``. Every ``greedy_every``-th request goes to a
pipeline with the noise off (for the perceptual path, with the posterior's
mode too), so that its answers can be held against the reference; the
others sample, as the ``encode`` and ``embed`` commands do. ``path``:
"pixel" (frames resized on the card, the pixel RBVAE) or "percep" (frames
resized on the host to the SD input, the SD first stage, the percep RBVAE).

``host_memory``: "pageable" (frames in arrays that numpy allocated, as a
plain decoder's are: the copy to the card goes through the driver's
staging buffer at the host's memory bandwidth) or "pinned" (frames in
page-locked buffers, as a loader with ``pin_memory`` hands them: the copy
is the card's DMA). Either way ``run_frames`` gets numpy arrays.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import rbvae as ref
from portbench.reference import sd as refsd

REQUEST_SPAN = "portbench.request"


def make_frames(traffic: dict, seed: int, device) -> list[np.ndarray]:
    """Seeded frames with the structure of video: a coarse random image a
    frame, smoothly upsampled, plus fine noise; drawn on ``device`` and
    brought to host memory of the kind ``traffic["host_memory"]`` names."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    H, W = traffic["frame_hw"]
    n = traffic["batch"]
    # Page-locking needs a card: a run on the CPU (the tests) keeps numpy's.
    pinned = traffic.get("host_memory", "pageable") == "pinned" \
        and torch.device(device).type == "cuda"
    out = []
    for _ in range(traffic["batches"]):
        coarse = torch.rand((n, 3, 9, 16), generator=gen, device=device)
        x = torch.nn.functional.interpolate(coarse, size=(H, W),
                                            mode="bilinear",
                                            align_corners=False)
        x = x * 200.0 + torch.rand((n, 3, H, W), generator=gen,
                                   device=device) * 55.0
        if pinned:
            # The array's base keeps the page-locked tensor alive.
            arr = torch.empty((n, H, W, 3), dtype=torch.uint8,
                              pin_memory=True).numpy()
        else:
            arr = np.empty((n, H, W, 3), np.uint8)
        torch.from_numpy(arr).copy_(x.to(torch.uint8).permute(0, 2, 3, 1))
        out.append(arr)
    return out


def program_config(config: dict):
    """The program's configuration object, field for field the file's."""
    from svtpu_torch.config import RBVAEConfig

    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config["model"].items()}
    return RBVAEConfig(**model)


def sd_config(config: dict):
    from svtpu_torch.config import PerceptualConfig

    return PerceptualConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in config["sd"].items()})


class Latents:
    """Keeps what a perceptual encoder's ``encode_frames`` returns, the
    latents the timed path handed to the RBVAE (the posterior's mode, or
    its sample)."""

    def __init__(self, enc):
        self.last = None
        self._encode = enc.encode_frames
        enc.encode_frames = self

    def __call__(self, frames):
        self.last = self._encode(frames)
        return self.last


def pipelines(h, weights: dict, sd_weights):
    """The noisy and the greedy pipeline of the cell, and, on the
    perceptual path, the keepers of their latents. ``h.fault`` plants a
    fault in the noisy pipeline: ``"noise_off"`` (no noise, the
    posterior's mode), ``"noise_x2"`` (the sampler's noise scale
    doubled)."""
    from svtpu_torch.pipeline import VideoSymbolPipeline

    traffic, dev = h.cell["traffic"], h.device
    cfg = program_config(h.config)
    common = dict(temperature=traffic["temperature"], hard=True,
                  seed=h.seed & 0xFFFFFFFF, batch=traffic["batch"],
                  resize_on=traffic["resize_on"], device=dev)
    ratio = traffic["noise_ratio"]
    noisy = dict(common, noise=h.fault != "noise_off",
                 noise_ratio=2 * ratio if h.fault == "noise_x2" else ratio)
    greedy = dict(common, noise=False, noise_ratio=ratio)
    if traffic["path"] == "pixel":
        return (VideoSymbolPipeline(cfg, weights, **noisy),
                VideoSymbolPipeline(cfg, weights, **greedy), None, None)
    from svtpu_torch.perceptual.embed import PerceptualEncoder

    def enc(stochastic):
        return PerceptualEncoder(sd_weights, sd_config(h.config),
                                 batch_size=traffic["batch"],
                                 stochastic=stochastic,
                                 seed=h.seed & 0xFFFFFFFF, device=dev)

    n = VideoSymbolPipeline(cfg, weights, percep=enc(noisy["noise"]),
                            **noisy)
    g = VideoSymbolPipeline(cfg, weights, percep=enc(False), **greedy)
    return n, g, Latents(n.percep), Latents(g.percep)


def run(h) -> None:
    from svtpu_torch.models.encode_graph import EncodeGraph

    traffic, config = h.cell["traffic"], h.config
    dev = h.device
    weights = ref.init_weights(config["model"], h.seed, dev,
                               h.cell.get("weight_gains"))
    sd_weights = refsd.init_weights(config["sd"], h.seed + 2, dev) \
        if traffic["path"] == "percep" else None
    frames = make_frames(traffic, h.seed + 1, dev)
    noisy, greedy, keep_noisy, keep_greedy = pipelines(h, weights,
                                                       sd_weights)
    # Every key the window uses: eager, captured, replayed.
    for pipe in (noisy, greedy):
        for k in range(3):
            pipe.run_frames(frames[k % len(frames)], batch_index=2 ** 31 - k)
    captures = EncodeGraph.captures

    every = traffic["greedy_every"]
    ends, outputs = [], []
    h.open_window()
    i = 0
    while not h.window_over():
        is_greedy = i % every == every - 1
        pipe = greedy if is_greedy else noisy
        try:
            with torch.profiler.record_function(REQUEST_SPAN):
                codes = pipe.run_frames(frames[i % len(frames)],
                                        batch_index=i)
        except Exception as e:          # counted, and the run is not correct
            h.failed += 1
            h.note(f"request {i} failed: {e!r}")
            codes = None
        ends.append(time.perf_counter() - h.t0)
        keeper = keep_greedy if is_greedy else keep_noisy
        latents = keeper.last if keeper is not None and codes is not None \
            else None
        outputs.append((i, is_greedy, codes, latents))
        i += 1
    window = h.close_window()
    h.attempted = i
    done = sum(o[2] is not None for o in outputs)
    h.e2e["encode_frames_per_s"] = done * traffic["batch"] / window
    h.work["frames"] = done * traffic["batch"]
    h.note(f"window {window:.3f} s: {i} requests, {h.failed} failed, "
           f"graph captures inside it: {EncodeGraph.captures - captures}; "
           f"requests a fifth of it: {np.histogram(ends, 5)[0].tolist()}")
    h.read_peak()
    for pipe in (noisy, greedy):
        pipe.drop_graphs()
        if pipe.percep is not None:
            pipe.percep.drop_graphs()
    del noisy, greedy, keep_noisy, keep_greedy
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(h, weights, sd_weights, frames, outputs)


def reference_h(h, weights: dict, z: torch.Tensor, low: bool
                ) -> torch.Tensor:
    """The reference's encoder-LSTM output ``h [N, L]`` of a batch of the
    RBVAE's inputs: frames ``[N, H, W, 3]`` in [0, 1] at the model's size
    (pixel path) or scaled SD latents (perceptual path)."""
    model = h.config["model"]
    logits = ref.trunk(weights, model, z, low)
    return ref.lstm(weights, "encoder_rnn", model, logits[:, None],
                    low)[:, 0].float()


def reference_inputs(h, sd_weights, x_u8, low: bool):
    """The reference's RBVAE input of a batch of uint8 frames (the scaled
    posterior mode on the perceptual path), and on the perceptual path the
    posterior's mean and standard deviation, unscaled."""
    if sd_weights is None:
        return ref.frames01(x_u8, h.config["model"]["input_hw"]), None
    sd = h.config["sd"]
    x = refsd.resize_host(x_u8.cpu(), h.cell["traffic"]["sd_hw"])
    mean, std = refsd.posterior(sd_weights, sd, x.to(h.device), low)
    return sd["scale_factor"] * mean, (mean, std)


class Tally:
    """What the noisy answers add up to. A sampled bit is 1 where ``h +
    s * logistic`` is above 0, so it lies off the sign of ``h`` with
    probability ``sigmoid(-|h| / s)``: ``flip_z`` is the number of bits
    off the reference's sign less its expectation, over its standard
    deviation, a standard normal's size where the program samples as it
    should. On the perceptual path the latents are the posterior's sample
    ``scale * (mean + std * e)``: ``posterior_dev`` is the larger of
    ``|mean(e)|`` and ``|rms(e) - 1|``, with ``e`` worked out against the
    reference's mean and deviation (not a z-score: over millions of
    elements that would read bfloat16's rounding of the deviation)."""

    def __init__(self):
        self.off = self.expect = self.var = 0.0
        self.n = self.e1 = self.e2 = 0.0

    def bits(self, b: torch.Tensor, href: torch.Tensor, scale: float):
        p = torch.sigmoid(-href.abs().double() / scale)
        self.off += float(((b > 0.5) != (href > 0)).sum())
        self.expect += float(p.sum())
        self.var += float((p * (1 - p)).sum())

    def posterior(self, e: torch.Tensor):
        e = e.double()
        self.n += e.numel()
        self.e1 += float(e.sum())
        self.e2 += float((e * e).sum())

    def numbers(self) -> dict:
        out = {}
        if self.var > 0:
            out["flip_z"] = abs(self.off - self.expect) / self.var ** 0.5
        if self.n > 0:
            out["posterior_dev"] = max(abs(self.e1) / self.n,
                                       abs((self.e2 / self.n) ** 0.5 - 1))
        return out


def control_draws(h, i: int, shape, kind: int) -> torch.Tensor:
    """The control's own draws for request ``i``: uniforms (``kind`` 0)
    or normals (1), from a generator seeded by the run's seed."""
    gen = torch.Generator(device=h.device)
    gen.manual_seed((h.seed * 1_000_003 + 2 * i + kind) % (2 ** 63))
    if kind == 0:
        return torch.rand(shape, generator=gen, device=h.device)
    return torch.randn(shape, generator=gen, device=h.device)


def check(h, weights: dict, sd_weights, frames: list, outputs: list) -> None:
    """Hold a sample of the window's answers, drawn from the seed, against
    the float32 reference. A greedy request's bit must lie on the side of
    0 where the reference's ``h`` lies (``code_gap``: the widest distance
    by which one does not), and on the perceptual path its latents must be
    the reference's posterior mode (``latent_err``: the largest ``|z -
    z_ref| / |z_ref|`` of a batch). A noisy request's bits must cross the
    reference's sign as often as the noise makes them (``flip_z``, of
    ``Tally``), and on the perceptual path its latents must be a sample of
    the reference's posterior (``posterior_dev``); there the reference's
    ``h`` is worked out from the sampled latents, the program's draw."""
    traffic, model = h.cell["traffic"], h.config["model"]
    ref.exact_matmuls()
    rng = np.random.default_rng(h.seed)
    done = [o for o in outputs if o[2] is not None]
    nb = len(frames)
    # Greedy answers of one batch are one answer: one of each batch seen.
    greedy = list({o[0] % nb: o for o in done if o[1]}.values())
    noisy = [o for o in done if not o[1]]
    picks = []
    for pool, n in ((greedy, traffic["check_greedy"]),
                    (noisy, traffic["check_noisy"])):
        if pool:
            sel = rng.choice(len(pool), min(n, len(pool)), replace=False)
            picks += [pool[j] for j in sorted(sel)]
    gap, zerr, malformed, flips, bits = 0.0, 0.0, 0, 0, 0
    tally = Tally()
    L = model["latent_dim"]
    scale = traffic["noise_ratio"]
    percep = sd_weights is not None
    sf = h.config["sd"]["scale_factor"] if percep else 1.0
    with torch.no_grad():
        for i, is_greedy, codes, latents in picks:
            x = torch.from_numpy(frames[i % nb]).to(h.device)
            if codes.shape != (traffic["batch"], L) or not np.isin(
                    codes, (0, 1)).all():
                malformed += 1
                continue
            zin, post = reference_inputs(h, sd_weights, x, False)
            if h.control:
                # The reference one precision below, in the program's
                # place: its own latents, draws and bits.
                zlow, plow = reference_inputs(h, sd_weights, x,
                                              h.control)
                if percep and not is_greedy:
                    zlow = sf * (plow[0] + plow[1] * control_draws(
                        h, i, plow[0].shape, 1))
                hlow = reference_h(h, weights, zlow, h.control)
                if not is_greedy:
                    u = control_draws(h, i, hlow.shape, 0)
                    hlow = hlow + scale * (torch.log(u + 1e-8)
                                           - torch.log(1 - u + 1e-8))
                codes = (hlow > 0).to(torch.uint8).cpu().numpy()
                latents = zlow.cpu().numpy() if percep else None
            b = torch.from_numpy(codes.astype(np.float32)).to(h.device)
            z = torch.from_numpy(np.asarray(latents)).to(h.device) \
                if percep else None
            if is_greedy:
                href = reference_h(h, weights, zin, False)
                if percep:
                    zerr = max(zerr, float((z - zin).norm() / zin.norm()))
                gap = max(gap, float(torch.relu(-(2 * b - 1) * href).max()))
                flips += int(((b > 0.5) != (href > 0)).sum())
                bits += b.numel()
            else:
                if percep:
                    tally.posterior((z / sf - post[0]) / post[1])
                href = reference_h(h, weights, z if percep else zin, False)
                tally.bits(b, href, scale)
    h.note(f"greedy bits checked {bits}, off the reference's sign {flips}; "
           f"noisy bits off it {tally.off:.0f}, expected "
           f"{tally.expect:.1f} +- {tally.var ** 0.5:.1f}")
    numbers = {"code_gap": gap, "latent_err": zerr, **tally.numbers()}
    for name, limit in h.limits.items():
        # A number with a limit that the sample could not give fails.
        h.compare(name, numbers.get(name, float("nan")), limit)
    for name, value in numbers.items():
        if name not in h.limits:
            h.note(f"not compared: {name} {value!r}")
    h.compare("malformed", malformed, 0)
    h.compare("unchecked", int(not picks), 0)
