"""Batched perceptual-embedding encoder, on one card or data-parallel over
a mesh; the port of ``svtpu/perceptual/embed.py``.

Only the AutoencoderKL runs (no UNet or CLIP); uint8 frames travel to the
card (unless they are there already) and are normalised there; the
posterior is sampled
(``posterior.sample()``, the reference's ``ddpm.py:542-549``) or taken at
its mode. Latents come back as NHWC ``[N, H/8, W/8, 4]`` float32 numpy
arrays, scaled by ``scale_factor``. On a mesh whose data axis has a group,
each rank encodes its rows of every batch, with the posterior noise of the
whole batch drawn and sliced (``ops/draws.py``), and the latents are
all-gathered: every rank returns what one process would. The encode pads
every batch of frames to ``batch_size`` by repeating its last frame, as
``svtpu`` pads it, so that a run has one shape. The encode and the decode
run eagerly on every device: as CUDA graphs they ran no faster on an H100,
and their private memory pools held 17.5 GiB and 32.9 GiB at batch 8.

``load_frame_pm1`` decodes an image file as the reference does (PIL,
imported where it is used), and ``precompute_embeddings`` turns a frame
directory into the reference's ``{"%010d.jpg": [1, 4, h, w]}`` ``.npy``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import PerceptualConfig
from svtpu_torch.evaluation.common import padded_chunks
from svtpu_torch.models.autoencoder_kl import AutoencoderKL, DiagonalGaussian
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.ops.draws import GlobalRows, ShardedGenerator
from svtpu_torch.parallel import distributed
from svtpu_torch.parallel.distributed import local_batch_to_global
from svtpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from svtpu_torch.utils.profiling import span


def preprocess_size(resize_wh: Tuple[int, int]) -> Tuple[int, int]:
    """(W, H) after the %32 snap (``get_percep_embeddings.py:59-66``):
    1280x720 → 1280x704."""
    w, h = resize_wh
    return (w - w % 32, h - h % 32)


def load_frame_pm1(path: str, resize_wh: Tuple[int, int]) -> np.ndarray:
    """Decode one frame the way the reference does: RGB → LANCZOS resize →
    %32 snap → uint8 HWC (normalization to [-1,1] happens on the card)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize(resize_wh, Image.LANCZOS)
    w, h = preprocess_size(resize_wh)
    if (w, h) != resize_wh:
        img = img.resize((w, h), Image.LANCZOS)
    return np.asarray(img, np.uint8)


class PerceptualEncoder(GraphedEncodes):
    """AutoencoderKL encode and decode in batches of ``batch_size``.

    ``PerceptualEncoder.resizes`` counts, over the process, the batches
    that ``run_frames`` resized to ``input_hw`` on an encoder's device.

    Args:
      params: the AutoencoderKL's CompVis-named state dict (from
        ``perceptual.convert``).
      stochastic: sample the posterior (True) or take its mode.
      seed: posterior noise; the batch starting at frame ``i`` draws from
        ``batch_seed(seed, i)``, in place of ``fold_in(key(seed), i)``.
      device: CUDA unless ``"cpu"`` is asked for (under NCCL, this rank's
        card).
      use_kernel: the mid-block attention through the hand-written kernel.
      mesh: a ``parallel.mesh.Mesh`` whose "data" axis splits each batch;
        ``make_mesh()`` by default (one rank without a process group). The
        batch size is rounded up to a multiple of the axis.
    """

    resizes = 0

    def __init__(self, params: Mapping[str, torch.Tensor],
                 cfg: PerceptualConfig = PerceptualConfig(),
                 batch_size: int = 8, stochastic: bool = True, seed: int = 0,
                 device=None, use_kernel: bool = True, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = AutoencoderKL(cfg, device=self.device,
                                   use_kernel=use_kernel)
        self.model.load_state_dict(params)
        self.mesh = mesh if mesh is not None else make_mesh()
        ndata = self.mesh.size("data")
        self.batch_size = -(-batch_size // ndata) * ndata
        self.stochastic = stochastic
        self.seed = seed

    @property
    def input_hw(self) -> Tuple[int, int]:
        """The SD input ``(h, w)``, to which ``run_frames`` resizes frames
        of another size, on this encoder's device (``encode_frames``
        itself never resizes)."""
        w, h = preprocess_size(self.cfg.resize_wh)
        return h, w

    @property
    def frames_per_code(self) -> int:
        """One latent a frame."""
        return 1

    def _rows(self, n: int):
        """This rank's rows ``[lo, hi)`` of an ``n``-row batch (``n`` a
        multiple of the data axis); all of them where the axis has no
        group."""
        if self.mesh.group("data") is None:
            return 0, n
        per = n // self.mesh.size("data")
        lo = self.mesh.rank("data") * per
        return lo, lo + per

    def _encode_body(self, inputs, _temperature, _noise_scale, gen):
        """The device work of one batch of this rank's frames (``svtpu``'s
        jitted ``encode``): uint8 → [-1, 1] → the posterior → a sample
        (from ``gen``, at this rank's rows of the batch) or its mode,
        scaled."""
        (part,) = inputs
        x = part.float() * (2.0 / 255.0) - 1.0
        post = DiagonalGaussian.from_moments(self.model.encode(x))
        if gen is None:
            return self.cfg.scale_factor * post.mode()
        if self.mesh.group("data") is not None:
            rows = torch.arange(*self._rows(self.batch_size),
                                device=self.device)
            gen = ShardedGenerator(gen, GlobalRows(rows, self.batch_size))
        return self.cfg.scale_factor * post.sample(gen)

    def _decode_body(self, inputs, _temperature, _noise_scale, _gen):
        """The device work of one batch of this rank's latents (``svtpu``'s
        jitted ``decode``): unscale → decode → [0, 1] pixels."""
        (z,) = inputs
        x = self.model.decode(z / self.cfg.scale_factor)
        return torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0)

    def encode_frames(self, frames_u8) -> np.ndarray:
        """``[N, H, W, 3]`` uint8 (numpy, or a tensor on the host or on this
        encoder's device) → ``[N, H/8, W/8, 4]`` float32 latents on the
        host, ``batch_size`` frames a batch, the last padded to it
        (``padded_chunks``) where the frames lie. Host frames go to the
        device a batch (this rank's rows) at a time; frames already there
        are padded and sliced there, and encoded with no copy."""
        if torch.is_tensor(frames_u8):
            frames = frames_u8.contiguous()
        else:
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
        lo, hi = self._rows(self.batch_size)
        out = []
        with span("svtpu.percep.encode_frames"), torch.inference_mode():
            for i, part, n in padded_chunks(frames, self.batch_size):
                seed = batch_seed(self.seed, i) if self.stochastic else None
                z = self.run_encode("sd encode", self.model, (),
                                    self._encode_body, (part[lo:hi],),
                                    seed=seed)
                z = local_batch_to_global(z, self.mesh)[:n]
                with span("svtpu.percep.readback.wait"):
                    out.append(z.cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def decode_latents(self, z_nhwc: np.ndarray) -> np.ndarray:
        """Scaled latents → [0, 1] pixels ``[N, H, W, 3]`` float32,
        ``batch_size`` latents a batch, split over the data axis on a mesh.
        The last batch is padded (``pad_to_multiple``) to a multiple of the
        data axis."""
        z = np.ascontiguousarray(z_nhwc, np.float32)
        out = []
        with torch.inference_mode():
            for i in range(0, len(z), self.batch_size):
                zb, n = pad_to_multiple(z[i:i + self.batch_size],
                                        self.mesh.size("data"))
                lo, hi = self._rows(len(zb))
                x = self.run_encode("sd decode", self.model, (),
                                    self._decode_body,
                                    (torch.from_numpy(zb[lo:hi]),))
                out.append(local_batch_to_global(x, self.mesh)[:n]
                           .cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)


def precompute_embeddings(frames_dir: str | Path, out_path: str | Path,
                          params: Mapping[str, torch.Tensor],
                          cfg: PerceptualConfig = PerceptualConfig(),
                          batch_size: int = 8, stochastic: bool = True,
                          seed: int = 0, pattern: str = "*.jpg",
                          workers: int = 16, device=None
                          ) -> Dict[str, np.ndarray]:
    """Frames dir → the reference's ``<video>_perceps.npy`` dict
    ``{file name: float32 [1, 4, h, w]}``, written with ``np.save`` when
    ``out_path`` is given. Under a process group every rank encodes its
    rows of each batch and returns the whole dict; rank 0 alone writes the
    file, and the other ranks wait for it.

    Frames go ``max(4 * batch_size, 32)`` at a time; a pool of ``workers``
    threads decodes chunk k+1 (``load_frame_pm1``) while the card encodes
    chunk k, whose posterior noise is seeded by ``seed + k * chunk``. The
    next chunk's decode is driven from a thread of its own, so that no
    task of the pool waits on the pool.
    """
    frames_dir = Path(frames_dir)
    paths = sorted(frames_dir.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no frames matching {pattern} in {frames_dir}")

    enc = PerceptualEncoder(params, cfg, batch_size=batch_size,
                            stochastic=stochastic, seed=seed, device=device)
    chunk = max(enc.batch_size * 4, 32)
    latents_parts = []
    with ThreadPoolExecutor(max_workers=workers) as ex, \
            ThreadPoolExecutor(max_workers=1) as ahead:
        def decode_chunk(i):
            return np.stack(list(ex.map(
                lambda p: load_frame_pm1(str(p), cfg.resize_wh),
                paths[i:i + chunk])))

        pending = decode_chunk(0)
        for i in range(0, len(paths), chunk):
            nxt = (ahead.submit(decode_chunk, i + chunk)
                   if i + chunk < len(paths) else None)
            enc.seed = seed + i   # decorrelate posterior noise across chunks
            latents_parts.append(enc.encode_frames(pending))
            pending = nxt.result() if nxt is not None else None
    latents = np.concatenate(latents_parts)    # [N, h, w, 4]
    emb = {p.name: np.transpose(z, (2, 0, 1))[None].astype(np.float32)
           for p, z in zip(paths, latents)}    # [1, 4, h, w] like reference
    if out_path:                               # np.load(...).item() reads it
        distributed.main_then_barrier(np.save, out_path, emb)
    return emb
