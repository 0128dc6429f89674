"""Video / frames → binary-symbol serving pipeline (``svtpu/pipeline.py``).

  video:       ``run_video``: a producer thread decodes the file (the native
               libav reader where it is built, else cv2) ``depth`` batches
               ahead of the card; each batch goes through ``run_frames``
  pixel path:  uint8 frames (host) → device: → float [0,1] → bilinear
               resize → RBVAE encode (hard Binary-Concrete codes) → codes
  percep path: uint8 frames (host) → host resize to the SD input (1280x704)
               → ``PerceptualEncoder.encode_frames`` (SD latents, the
               attention kernel inside) → percep RBVAE encode → codes

With ``cfg.pallas_trunk`` and ``cfg.pallas_sampler`` set, the RBVAE encode
runs through the hand-written CUDA kernels. On a card the device work of
each path's encode (pixel: from the uint8 batch to the codes; percep: the
RBVAE encode of the latents) is one CUDA graph a batch shape, as
``svtpu`` jits it (``models/encode_graph.py``); on the CPU it runs eagerly.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.ops.image import resize_bilinear, resize_u8, to_float01
from svtpu_torch.perceptual.embed import preprocess_size
from svtpu_torch.utils.profiling import span


class VideoSymbolPipeline(GraphedEncodes):
    """Frame batches → ``[N, latent]`` binary codes.

    Args:
      cfg / params: the RBVAE model; ``params`` is its torch state dict
        (reference names, e.g. from ``models.convert.from_jax_params``).
      percep: optional ``PerceptualEncoder``: frames are resized on the
        host to the SD input and SD-encoded first (the percep-RBVAE path).
      temperature / hard / noise / noise_ratio: encode protocol (defaults =
        reference eval: temperature 0.2, hard, noise on).
      seed: noise seed; batch ``i`` draws from ``batch_seed(seed, i)``.
      batch: frames per ``run_video`` step; the last batch is padded by
        repeating its last frame, and only its real frames' codes are kept.
      depth: batches ``run_video`` decodes ahead of the card. It decodes
        with the native libav reader where ``svtpu_torch.data.native`` is
        built, else with cv2, as ``svtpu`` chooses.
      resize_on: "device" resizes on the card after transfer, as
        ``jax.image.resize`` does (antialiased); "host" resizes the uint8
        frames on the CPU first, as the reference's ``cv2.resize(...,
        INTER_LINEAR)`` does (fewer bytes to move).
      device: CUDA unless ``"cpu"`` is asked for. On a card the encode
        runs as a CUDA graph a batch shape (``graph_route``);
        ``drop_graphs()`` frees them.
    """

    def __init__(self, cfg: RBVAEConfig, params: Mapping[str, torch.Tensor],
                 *, percep=None, temperature: float = 0.2,
                 hard: bool = True, noise: bool = True,
                 noise_ratio: float = 0.1, seed: int = 0,
                 batch: int = 64, depth: int = 2,
                 resize_on: str = "device", device=None):
        if resize_on not in ("device", "host"):
            raise ValueError(f"resize_on must be 'device' or 'host': "
                             f"{resize_on!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Seq2SeqBinaryVAE(cfg, device=self.device)
        self.model.load_state_dict(params)
        self.temperature = temperature
        self.hard = hard
        self.noise = noise
        self.noise_ratio = noise_ratio
        self.seed = seed
        self.batch = batch
        self.depth = depth
        self.resize_on = resize_on
        self.percep = percep
        if percep is not None:
            w, h = preprocess_size(percep.cfg.resize_wh)
            self._sd_hw = (h, w)
        self._graphed = graph_route(self.device) == "graph"

    def _frame_batches(self, video_path: str
                       ) -> Iterator[tuple[np.ndarray, int]]:
        """``(batch, valid)``: ``[batch, H, W, 3]`` uint8 frames of the
        video, the last batch padded with copies of its last frame, and how
        many of them are real."""
        from svtpu_torch.data import native

        def pad(frames):
            n = len(frames)
            if n == self.batch:
                return frames, n
            return np.concatenate(
                [frames, np.repeat(frames[-1:], self.batch - n, 0)]), n

        if native.available():
            with native.VideoReader(video_path) as vr:
                while True:
                    frames = vr.read_batch(self.batch)
                    if not len(frames):
                        return
                    yield pad(frames)
        from svtpu_torch.data.frames import iter_frames_cv2

        buf = []
        with contextlib.closing(iter_frames_cv2(video_path)) as it:
            for frame in it:
                buf.append(frame)
                if len(buf) == self.batch:
                    yield np.stack(buf), self.batch
                    buf = []
        if buf:
            yield pad(np.stack(buf))

    def run_video(self, video_path: str,
                  limit: Optional[int] = None) -> np.ndarray:
        """Decode and encode a whole video (its first ``limit`` frames) →
        ``[num_frames, latent]`` codes.

        A producer thread decodes ``depth`` batches ahead; batch ``b`` (its
        ordinal: 0, 1, 2, ...) is encoded by ``run_frames(batch,
        batch_index=b)``. An exception in the decoder (a missing or broken
        file) is raised here, in the caller; the thread never outlives the
        call."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                n = 0
                with contextlib.closing(
                        self._frame_batches(video_path)) as batches:
                    for frames, valid in batches:
                        take = valid if limit is None \
                            else min(valid, limit - n)
                        if take <= 0 or not put((frames, take)):
                            break
                        n += take
                put(end)
            except BaseException as e:  # handed to the caller
                put(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="run_video-decode")
        thread.start()
        out = []
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                frames, take = item
                out.append(self.run_frames(frames, batch_index=len(out))
                           [:take])
        finally:
            stop.set()
            thread.join()
        return np.concatenate(out) if out else np.zeros(
            (0, self.cfg.latent_dim))

    def _codes(self, inputs, temperature, noise_ratio, generator):
        """The device work of one batch (``svtpu``'s jitted ``encode`` /
        ``encode_emb``): pixel path, uint8 frames → [0, 1] → resize →
        codes; percep path, SD latents → codes."""
        (x,) = inputs
        if self.percep is None:
            x = resize_bilinear(to_float01(x), tuple(self.cfg.input_hw))
        z = self.model.encode(x[:, None], temperature, self.hard,
                              noise_ratio, deterministic=not self.noise,
                              generator=generator)
        return z[:, 0].to(torch.uint8 if self.hard else torch.float32)

    def run_frames(self, frames_u8: np.ndarray,
                   batch_index: int = 0) -> np.ndarray:
        """Encode one uint8 ``[N, H, W, C]`` frame batch (any resolution)."""
        with span("svtpu.pipeline.run_frames"):
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
            target = self._sd_hw if self.percep is not None \
                else tuple(self.cfg.input_hw)
            if (self.percep is not None or self.resize_on == "host") \
                    and tuple(frames.shape[1:3]) != target:
                with span("svtpu.pipeline.resize_host"):
                    frames = resize_u8(frames, target)
            seed = batch_seed(self.seed, batch_index) if self.noise else None
            x = frames if self.percep is None else torch.from_numpy(
                self.percep.encode_frames(frames.numpy()))
            with span("svtpu.pipeline.encode"), torch.inference_mode():
                z = self.run_encode("run_frames", self.model,
                                    (self.hard, self.noise), self._codes,
                                    (x,), self.temperature, self.noise_ratio,
                                    seed)
            with span("svtpu.pipeline.readback.wait"):
                return z.cpu().numpy()

