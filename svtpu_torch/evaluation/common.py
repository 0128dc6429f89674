"""Shared evaluation utilities: model bundles and batched encoding
(``svtpu/evaluation/common.py:13-74``)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from svtpu_torch import batch_seed, resolve_device
from svtpu_torch.config import RBVAEConfig
from svtpu_torch.data.segments import assign_label
from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
from svtpu_torch.training.checkpoints import BestCheckpointer


def padded_chunks(frames: np.ndarray, chunk: int):
    """``(offset, part, n)`` for each run of ``chunk`` frames: ``part``
    holds ``n`` frames, the last one padded to ``chunk`` by repeating its
    last frame, so every step has one shape."""
    for i in range(0, len(frames), chunk):
        part = frames[i:i + chunk]
        n = len(part)
        if n < chunk:
            part = np.concatenate([part, np.repeat(part[-1:], chunk - n, 0)])
        yield i, part, n


@torch.no_grad()
def encode_chunks(model: Seq2SeqBinaryVAE, frames: np.ndarray,
                  load: Callable[[np.ndarray], torch.Tensor],
                  temperature: float, hard: bool = True, noise: bool = True,
                  noise_ratio: float = 0.1, seed: int = 0,
                  chunk: int = 128) -> np.ndarray:
    """Batched single-frame encode → codes ``[N, latent]`` on the host.

    Each frame is a T=1 sequence, ``chunk`` frames at a time
    (``padded_chunks``); the chunk at offset ``i`` draws its noise from
    ``batch_seed(seed, i)`` on a generator on the model's device. ``load``
    maps a chunk of ``frames`` to the model's float input on its device.
    ``model.encode`` runs the kernels the model config asks for.
    """
    device = next(model.parameters()).device
    out = []
    for i, part, n in padded_chunks(frames, chunk):
        gen = None
        if noise:
            gen = torch.Generator(device=device)
            gen.manual_seed(batch_seed(seed, i))
        z = model.encode(load(part)[:, None], temperature, hard, noise_ratio,
                         deterministic=not noise, generator=gen)
        out.append(z[:n, 0].float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,))


class RBVAEBundle:
    """A model and its weights on one device, the unit every evaluation
    consumes.

    ``state_dict``: the reference torch layout the port's model holds (a
    reference ``.pt`` state dict loads as it is). ``device``: CUDA unless
    ``"cpu"`` is asked for (raises when there is no card).
    """

    def __init__(self, cfg: RBVAEConfig, state_dict, name: str = "rbvae",
                 device=None):
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.model = Seq2SeqBinaryVAE(cfg, device=self.device)
        self.model.load_state_dict(state_dict)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg: RBVAEConfig,
                        which: str = "best", name: str = "rbvae",
                        device=None) -> "RBVAEBundle":
        """A bundle from a ``BestCheckpointer`` directory written by
        ``Trainer.train`` (its tree holds ``{"model": state_dict, ...}``)."""
        tree, _meta = BestCheckpointer(ckpt_dir).restore(which)
        return cls(cfg, tree["model"], name=name, device=device)

    def load_frames(self, part: np.ndarray) -> torch.Tensor:
        """Host frames → float input on the device; uint8 is scaled to
        [0, 1] as ``svtpu``'s bundle scales it (``/ 255``)."""
        x = torch.from_numpy(np.ascontiguousarray(part)).to(self.device)
        return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()

    def encode(self, frames: np.ndarray, temperature: float = 0.2,
               hard: bool = True, noise: bool = True,
               noise_ratio: float = 0.1, seed: int = 0,
               chunk: int = 128) -> np.ndarray:
        """Batched single-frame encode → ``[N, latent]`` float codes on the
        host (the reference eval protocol: temperature 0.2, hard, noise
        on), ``chunk`` frames a step (see ``encode_chunks``)."""
        return encode_chunks(self.model, np.asarray(frames), self.load_frames,
                             temperature, hard, noise, noise_ratio, seed,
                             chunk)


def labels_of(frame_indices, flags, labels: Optional[np.ndarray] = None):
    """Per-frame state labels and the number of states: ``labels`` when
    given (one global state axis across videos), else each frame's state
    from the transition ``flags``."""
    if labels is not None:
        labels = np.asarray(labels)
        return labels, int(labels.max()) + 1
    return (np.asarray([assign_label(i, flags) for i in frame_indices]),
            len(flags) + 1)
