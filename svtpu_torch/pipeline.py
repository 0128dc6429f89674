"""Video / frames → binary-symbol serving pipeline (``svtpu/pipeline.py``).

  video:       ``run_video``: a producer thread decodes the file (the native
               libav reader where it is built, else cv2) ``depth`` batches
               ahead of the card; each batch goes through ``run_frames``
  pixel path:  uint8 frames (host) → device: → float [0,1] → bilinear
               resize → RBVAE encode (hard Binary-Concrete codes) → codes
  percep path: uint8 frames (host) → where they differ from
               ``percep.input_hw`` (the SD input, 1280x704; none for
               ``ClipEncoder``, which resizes inside its encode), copied to
               the encoder's device and resized there, still uint8 →
               ``percep.encode_frames`` (SD latents, or V-JEPA 2's
               features of 64-frame clips kept on the card) → percep RBVAE
               encode → a code a ``frames_per_code`` frames

With ``cfg.pallas_trunk`` and ``cfg.pallas_sampler`` set, the RBVAE encode
runs through the hand-written CUDA kernels. On a card the device work of
each path's encode (pixel: from the uint8 batch to the codes; percep: the
RBVAE encode of the latents or features) is one CUDA graph a batch shape, as
``svtpu`` jits it (``models/encode_graph.py``); on the CPU it runs eagerly.

On the graph route a pixel batch of more than ``COPY_CHUNK_BYTES`` goes to
the card in chunks (``frame_chunks``): each chunk is copied on the
pipeline's copy stream and resized on the current stream as soon as it has
landed, while the next one is copied, so the host link and the card work
at once. The graph then encodes the resized batch whole.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.models.encode_graph import GraphedEncodes
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.ops.image import resize_u8
from svtpu_torch.utils.profiling import span

# A pixel batch of more bytes than this is copied to the card in at most
# COPY_CHUNKS chunks (``frame_chunks``), the first ones resized while the
# later ones are still on their way. On an H100, 64 HD frames (177 MB) in 4
# chunks ran slower than in 8 (the last chunk's resize, which nothing
# overlaps, is then a quarter of the batch's); 12 and 16 ran no faster.
COPY_CHUNK_BYTES = 32 << 20
COPY_CHUNKS = 8


def frame_chunks(n: int, nbytes: int) -> list[slice]:
    """The chunks in which ``run_frames`` copies a batch of ``n`` frames,
    ``nbytes`` in all, to the card: the whole batch where it holds at most
    ``COPY_CHUNK_BYTES``, else ``ceil(n / COPY_CHUNKS)`` frames a chunk, the
    last one shorter."""
    if nbytes <= COPY_CHUNK_BYTES:
        return [slice(0, n)]
    size = -(-n // COPY_CHUNKS)
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


def preprocess(x_u8: torch.Tensor, hw: tuple) -> torch.Tensor:
    """uint8 ``[N, H, W, C]`` frames → float32 [0, 1] → ``hw``
    (antialiased), as a ``[N, h, w, C]`` view of an NCHW batch. The numbers
    of ``resize_bilinear(to_float01(x_u8), hw)`` (``u * (1 / 255)`` rounds
    as ``to_float01``'s cast and product do) in fewer passes over the
    frames: one casts, scales and transposes them to a contiguous NCHW
    batch, which the resize reads as it is. Frame by frame: a chunk's
    result is its slice of the batch's."""
    n, H, W, C = x_u8.shape
    x = torch.empty((n, C, H, W), dtype=torch.float32, device=x_u8.device)
    torch.mul(x_u8.permute(0, 3, 1, 2), 1.0 / 255.0, out=x)
    if (H, W) != tuple(hw):
        x = F.interpolate(x, size=tuple(hw), mode="bilinear",
                          align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


class _Staging:
    """One batch shape's buffers on the card: the uint8 frames, written
    chunk by chunk on the copy stream, and the resized batch, written on the
    compute stream, with each chunk's views of both; an event a chunk,
    recorded when its copy has landed, and ``free``, recorded after the
    last chunk's resize, which the next request's copies wait for before
    they overwrite ``frames``."""

    def __init__(self, shape: tuple, hw: tuple, chunks: list, device):
        n, _, _, c = shape
        self.frames = torch.empty(shape, dtype=torch.uint8, device=device)
        self.resized = torch.empty((n, *hw, c), dtype=torch.float32,
                                   device=device)
        self.chunks = [(k, self.frames[k], self.resized[k],
                        torch.cuda.Event()) for k in chunks]
        self.free = torch.cuda.Event()


class VideoSymbolPipeline(GraphedEncodes):
    """Frame batches → ``[N, latent]`` binary codes.

    Args:
      cfg / params: the RBVAE model; ``params`` is its torch state dict
        (reference names, e.g. from ``models.convert.from_jax_params``).
      percep: optional perceptual encoder (``PerceptualEncoder``,
        ``ClipEncoder``): frames are resized to its ``input_hw`` where it
        has one, on its ``device`` (counted in its class's ``resizes``),
        encoded by its ``encode_frames`` (a host array or a tensor), and
        the RBVAE encodes the result; each code stands for the encoder's
        ``frames_per_code`` frames. ``resize_on`` does not apply.
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
        runs as a CUDA graph a batch shape (``graph_route``), and large
        pixel batches are copied in chunks into staging buffers on the
        card, one pair a batch shape; ``drop_graphs()`` frees both.

    ``copy_chunks`` counts, over the process, the chunks copied to the
    card on the chunked route.
    """

    copy_chunks = 0

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
        # The size uint8 frames are resized to before the encode, if they
        # are, and on which device: the perceptual encoder's, or the host.
        if percep is not None:
            self._u8_hw, self._u8_device = percep.input_hw, percep.device
        else:
            self._u8_hw = tuple(cfg.input_hw) if resize_on == "host" \
                else None
            self._u8_device = torch.device("cpu")
        self._graphed = graph_route(self.device) == "graph"
        self._staging: dict = {}
        self._copy_stream = None

    def drop_graphs(self) -> None:
        """Free the encode graphs and the staging buffers."""
        super().drop_graphs()
        self._staging = {}

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
        codes, or the frames ``_staged`` resized → codes; percep path, SD
        latents → codes; clip path, a tubelet's features → codes."""
        (x,) = inputs
        if x.dtype == torch.uint8:
            x = preprocess(x, self.cfg.input_hw).contiguous()
        z = self.model.encode(x[:, None], temperature, self.hard,
                              noise_ratio, deterministic=not self.noise,
                              generator=generator)
        return z[:, 0].to(torch.uint8 if self.hard else torch.float32)

    def _staged(self, frames: torch.Tensor) -> torch.Tensor:
        """The pixel batch ``frames`` (host) on the card and resized, copied
        chunk by chunk (``frame_chunks``) on the copy stream, each chunk
        resized on the current stream once it has landed; or ``frames``
        as they are where the batch is one chunk (the graph then copies
        and resizes it whole)."""
        chunks = frame_chunks(len(frames), frames.nbytes)
        if len(chunks) == 1:
            return frames
        hw = tuple(self.cfg.input_hw)
        st = self._staging.get(frames.shape)
        if st is None:
            st = self._staging[frames.shape] = _Staging(
                tuple(frames.shape), hw, chunks, self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        with span("svtpu.pipeline.copy_in"):
            copy.wait_event(st.free)
            for k, on_card, resized, landed in st.chunks:
                with torch.cuda.stream(copy):
                    on_card.copy_(frames[k], non_blocking=True)
                    landed.record(copy)
                compute.wait_event(landed)
                resized.copy_(preprocess(on_card, hw))
            st.free.record(compute)
        VideoSymbolPipeline.copy_chunks += len(chunks)
        return st.resized

    def run_frames(self, frames_u8: np.ndarray,
                   batch_index: int = 0) -> np.ndarray:
        """Encode one uint8 ``[N, H, W, C]`` frame batch (any resolution).

        On the graph route a pixel batch of more than ``COPY_CHUNK_BYTES``
        is copied to the card in chunks, from ``frames_u8`` itself, pinned
        or pageable (``_staged``; pageable chunks block the host while they
        are copied, and the card resizes the chunk before meanwhile). This
        returns after the codes are read back, and the readback is ordered
        after every copy from ``frames_u8``: the caller may overwrite it as
        soon as the call returns. On the percep path frames that need the
        resize are copied to the encoder's device whole (synchronously,
        from pageable memory) and resized there; a code stands for its
        encoder's ``frames_per_code`` frames."""
        with span("svtpu.pipeline.run_frames"):
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
            if self._u8_hw not in (None, tuple(frames.shape[1:3])):
                frames = frames.to(self._u8_device)
                # On a card the span times the resize's enqueue alone.
                with span("svtpu.pipeline.resize_host"):
                    frames = resize_u8(frames, self._u8_hw)
                if self.percep is not None:
                    type(self.percep).resizes += 1
            seed = batch_seed(self.seed, batch_index) if self.noise else None
            if self.percep is not None:
                x = torch.as_tensor(self.percep.encode_frames(frames))
            elif self._graphed:
                with torch.inference_mode():
                    x = self._staged(frames)
            else:
                x = frames
            with span("svtpu.pipeline.encode"), torch.inference_mode():
                z = self.run_encode("run_frames", self.model,
                                    (self.hard, self.noise), self._codes,
                                    (x,), self.temperature, self.noise_ratio,
                                    seed)
            with span("svtpu.pipeline.readback.wait"):
                z = z.cpu().numpy()
            if self.percep is not None:   # each code on its frames
                z = np.repeat(z, self.percep.frames_per_code,
                              axis=0)[:len(frames)]
            return z

