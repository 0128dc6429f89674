"""Process-group set-up and the collectives of data parallelism
(``svtpu/parallel/distributed.py``).

``svtpu`` is single-controller JAX: every host calls ``initialize()`` and
XLA inserts the collectives. The port is one process per card
(``torchrun``, or a caller that passes the address, the world size and the
rank itself) over ``torch.distributed``: NCCL between cards, gloo only
where the caller asks for the CPU. The collectives are explicit: gradients
are all-reduced before Adam (``all_reduce_mean_``), parameters broadcast
from rank 0 at initialisation (``broadcast_``), and a batch assembled from
the ranks' rows (``local_batch_to_global``).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Callable, Optional, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from svtpu_torch import resolve_device

# What a launcher (torchrun, or a caller following its convention) sets.
_LAUNCHER_ENV = ("WORLD_SIZE", "MASTER_ADDR", "TORCHELASTIC_RUN_ID")

T = TypeVar("T")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Start the process group when there is one to start.

    A no-op returning ``False`` in a single process with no launcher
    environment, so it is safe at the top of every entry point. Otherwise
    it calls ``torch.distributed.init_process_group`` and returns True.
    ``backend``: by default from ``device``, the device the caller names
    for its work: gloo for ``"cpu"``, NCCL otherwise, on the card of
    ``LOCAL_RANK`` (raises without a card, and does not fall back to gloo
    when NCCL fails). Already initialised: returns whether the world has
    more than one rank.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and not any(os.environ.get(k)
                                       for k in _LAUNCHER_ENV):
        return False
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl":
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return True


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``, without importing
    ``torch.distributed.tensor`` (with sympy behind it, a large share of a
    command's start-up): none exists before that module is loaded, which
    only a "model" mesh axis (``sharding.parallelize_rbvae``) or a caller's
    own ``DTensor`` does."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local_batch_to_global(batch, mesh, axis: str = "data") -> torch.Tensor:
    """The global batch from each rank's local rows along ``axis``
    (``[n * b, ...]`` from ``[b, ...]``, in rank order), on the mesh's
    device; the batch itself where the axis has no group."""
    x = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch)
    group = mesh.group(axis)
    if group is None:
        return x
    x = x.to(mesh.device).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, n: int) -> None:
    """Replace each tensor (a ``DTensor``: its local block) by its mean over
    the ``n`` ranks of ``group``: one all-reduce of the tensors packed into
    one buffer (a sum, then a divide: gloo has no average)."""
    if group is None or not tensors:
        return
    with torch.no_grad():
        tensors = [t.to_local() if is_dtensor(t) else t for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        flat /= n
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with global rank ``src``'s, in place (every
    rank of the world calls it)."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)


def is_main() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def launched_rank() -> int:
    """This process's rank: the process group's, else the ``RANK`` a
    launcher set, else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def barrier() -> None:
    """Wait until every rank of the world is here; a no-op without a
    process group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def main_then_barrier(fn: Callable[..., T], *args, **kwargs
                      ) -> Optional[T]:
    """``fn(*args, **kwargs)`` on the main process alone (a file write),
    then ``barrier()``: the other ranks wait for it, so that a read on any
    rank afterwards finds what it wrote. Returns ``fn``'s value on the
    main process and None on the others."""
    out = fn(*args, **kwargs) if is_main() else None
    barrier()
    return out


def same_on_every_rank(obj, what: str) -> None:
    """Raise ``RuntimeError`` where the ranks hold different ``obj``s
    (compared by a hash of its JSON); a no-op without a process group."""
    if not dist.is_initialized():
        return
    digest = hashlib.sha256(json.dumps(obj, sort_keys=True, default=str)
                            .encode()).hexdigest()
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    if len(set(digests)) > 1:
        raise RuntimeError(f"{what} differs across the ranks (digests "
                           f"{digests})")


def share(obj):
    """Rank 0's ``obj`` on every rank (``broadcast_object_list``); ``obj``
    itself without a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
