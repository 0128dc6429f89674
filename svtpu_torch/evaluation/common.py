"""Shared evaluation utilities: model bundles and batched encoding
(``svtpu/evaluation/common.py:13-74``)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.data.segments import assign_label
from svtpu_torch.models.encode_graph import (EncodeGraph, GraphedEncodes,
                                             run_encode)
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.ops.cuda_graph import graph_route
from svtpu_torch.training.checkpoints import BestCheckpointer


def padded_chunks(frames, chunk: int):
    """``(offset, part, n)`` for each run of ``chunk`` frames (a numpy
    array, or a tensor on any device, which the padding stays on):
    ``part`` holds ``n`` frames, the last one padded to ``chunk`` by
    repeating its last frame, so every step has one shape."""
    for i in range(0, len(frames), chunk):
        part = frames[i:i + chunk]
        n = len(part)
        if n < chunk:
            part = part[[*range(n)] + [n - 1] * (chunk - n)]
        yield i, part, n


def chunk_encoder(model: Seq2SeqBinaryVAE,
                  prep: Callable[[torch.Tensor], torch.Tensor], hard: bool,
                  noise: bool):
    """The device work of one chunk (``svtpu``'s jitted ``enc``): a chunk
    on the card → ``prep`` → ``model.encode`` as T=1 sequences → float
    codes ``[chunk, latent]``, as an ``EncodeGraph`` body."""

    def body(inputs, temperature, noise_ratio, generator):
        z = model.encode(prep(inputs[0])[:, None], temperature, hard,
                         noise_ratio, deterministic=not noise,
                         generator=generator)
        return z[:, 0].float()

    return body


@torch.no_grad()
def encode_chunks(model: Seq2SeqBinaryVAE, frames: np.ndarray,
                  prep: Callable[[torch.Tensor], torch.Tensor],
                  temperature: float, hard: bool = True, noise: bool = True,
                  noise_ratio: float = 0.1, seed: int = 0,
                  chunk: int = 128, graphs: Optional[EncodeGraph] = None
                  ) -> np.ndarray:
    """Batched single-frame encode → codes ``[N, latent]`` on the host.

    Each frame is a T=1 sequence, ``chunk`` frames at a time
    (``padded_chunks``); the chunk at offset ``i`` draws its noise from
    ``batch_seed(seed, i)`` on a generator on the model's device. A chunk
    of ``frames`` goes to the card as it is, and ``prep`` maps it there to
    the model's float input. ``model.encode`` runs the kernels the model
    config asks for. ``graphs``: the chunks run as its CUDA graphs
    (``svtpu``'s jitted encode, the temperature and noise ratio traced,
    ``hard`` and ``noise`` static). None: eagerly.
    """
    device = next(model.parameters()).device
    body = chunk_encoder(model, prep, hard, noise)
    out = []
    for i, part, n in padded_chunks(frames, chunk):
        z = run_encode(graphs, device, "encode_chunks", model,
                       (hard, noise), body,
                       (torch.from_numpy(np.ascontiguousarray(part)),),
                       temperature, noise_ratio,
                       batch_seed(seed, i) if noise else None)
        out.append(z[:n].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,))


class RBVAEBundle(GraphedEncodes):
    """A model and its weights on one device, the unit every evaluation
    consumes.

    ``state_dict``: the reference torch layout the port's model holds (a
    reference ``.pt`` state dict loads as it is). ``device``: CUDA unless
    ``"cpu"`` is asked for (raises when there is no card). On a card
    ``encode`` runs as a CUDA graph a chunk shape (``graph_route``);
    ``drop_graphs()`` frees them.
    """

    def __init__(self, cfg: RBVAEConfig, state_dict, name: str = "rbvae",
                 device=None):
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.model = Seq2SeqBinaryVAE(cfg, device=self.device)
        self.model.load_state_dict(state_dict)
        self._graphed = graph_route(self.device) == "graph"

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg: RBVAEConfig,
                        which: str = "best", name: str = "rbvae",
                        device=None) -> "RBVAEBundle":
        """A bundle from a ``BestCheckpointer`` directory written by
        ``Trainer.train`` (its tree holds ``{"model": state_dict, ...}``)."""
        tree, _meta = BestCheckpointer(ckpt_dir).restore(which)
        return cls(cfg, tree["model"], name=name, device=device)

    @staticmethod
    def prep(x: torch.Tensor) -> torch.Tensor:
        """Frames on the device → the model's float input; uint8 is scaled
        to [0, 1] as ``svtpu``'s bundle scales it (``/ 255``)."""
        return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()

    def load_frames(self, part: np.ndarray) -> torch.Tensor:
        """Host frames → the model's float input on the device (``prep``)."""
        return self.prep(torch.from_numpy(np.ascontiguousarray(part))
                         .to(self.device))

    def encode(self, frames: np.ndarray, temperature: float = 0.2,
               hard: bool = True, noise: bool = True,
               noise_ratio: float = 0.1, seed: int = 0,
               chunk: int = 128) -> np.ndarray:
        """Batched single-frame encode → ``[N, latent]`` float codes on the
        host (the reference eval protocol: temperature 0.2, hard, noise
        on), ``chunk`` frames a step (see ``encode_chunks``)."""
        return encode_chunks(self.model, np.asarray(frames), self.prep,
                             temperature, hard, noise, noise_ratio, seed,
                             chunk, self.encode_graphs())


def labels_of(frame_indices, flags, labels: Optional[np.ndarray] = None):
    """Per-frame state labels and the number of states: ``labels`` when
    given (one global state axis across videos), else each frame's state
    from the transition ``flags``."""
    if labels is not None:
        labels = np.asarray(labels)
        return labels, int(labels.max()) + 1
    return (np.asarray([assign_label(i, flags) for i in frame_indices]),
            len(flags) + 1)
