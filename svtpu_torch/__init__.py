"""svtpu_torch — the PyTorch/CUDA port of ``svtpu`` for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of ``svtpu`` on the
ported path is a CUDA kernel written by hand for ``sm_90a`` (``csrc/``),
built with ``nvcc`` at first use and bound through ``ctypes``
(``ops/_build.py``). The package imports nothing of JAX or of ``svtpu``:
``svtpu`` is the reference it is tested against (``tests/test_torch_*.py``).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card and no explicit device they raise. Under
a launcher (``python -m torch.distributed.run``) each process is one rank
on the card of its ``LOCAL_RANK`` (``parallel.distributed.initialize``).

Layer map (``svtpu``'s, ported):
  L0  svtpu_torch.data          — video → frames (cv2, native C++), stores,
                                  pair batches
  L1  svtpu_torch.perceptual    — SD-VAE embedding, data-parallel on a mesh
  L2  svtpu_torch.models        — AutoencoderKL, the four RBVAE variants,
                                  the model summary (``visualize``)
  L3  svtpu_torch.ops, csrc     — plain ops and the Hopper kernels
  L4  svtpu_torch.training      — the trainer (data and tensor parallel on
                                  a mesh), checkpoints, EMA and LR schedule
  L5  svtpu_torch.sweeps        — hyperparameter sweeps (W&B or local)
  L6  svtpu_torch.evaluation    — consistency/hamming/projection/probe evals
      svtpu_torch.parallel      — meshes, partition rules, process groups
      svtpu_torch.utils         — profiling and the environment report
      svtpu_torch.cli           — the command line
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


class NoCardError(RuntimeError):
    """CUDA was asked for and the process sees no card."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises ``NoCardError`` when CUDA is asked for (explicitly or by
    default) and there is no card, so nothing falls back to the CPU
    unasked. Under an initialised NCCL process group a bare ``"cuda"`` is
    this rank's card, ``cuda:<LOCAL_RANK>`` (modulo the cards the process
    sees; the current card where ``LOCAL_RANK`` is unset), so that no
    tensor lands on card 0 by accident.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise NoCardError(
            "svtpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    if (dev.index is None and dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) % torch.cuda.device_count()
                           if local is not None
                           else torch.cuda.current_device())
    return dev


_M64 = (1 << 64) - 1


def batch_seed(seed: int, batch_index: int) -> int:
    """One noise seed per batch from ``(seed, batch index)`` — the port's
    counterpart of ``jax.random.fold_in(key(seed), i)``.

    The pair is mixed by SplitMix64's finaliser, so that every bit of the
    result depends on both: a CPU ``torch.Generator`` seeds its Mersenne
    Twister from the low 32 bits only.
    """
    x = (((int(seed) & 0xFFFFFFFF) << 32 | (int(batch_index) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)
