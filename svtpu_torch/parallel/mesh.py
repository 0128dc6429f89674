"""Meshes of ranks and the placements over them (``svtpu/parallel/mesh.py``).

A ``Mesh`` lays the ranks of the process group out on a grid with named
axes (``("data",)``, or ``("data", "model")``): with a process group it
holds torch's ``DeviceMesh`` of that grid, whose per-axis groups the
collectives of an axis run over and on whose "model" axis tensor
parallelism places its ``DTensor`` parameters. In a single process with no
process group the mesh is one rank and has no ``DeviceMesh`` (torch's
needs a group): nothing is communicated, and a trainer or encoder on it
runs the single-device path. A ``Sharding`` says which mesh axis splits
which leading dimension of a tensor, as a ``PartitionSpec`` does in
``svtpu``; ``Sharding.local`` takes this rank's block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: the global ranks, shaped like the mesh (``svtpu``'s
    ``mesh.devices``). ``device``: where this rank's tensors live.
    ``device_mesh``: torch's ``DeviceMesh`` of the grid; ``None`` without a
    process group."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None
    device_mesh: Optional[DeviceMesh] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    def size(self, axis: str) -> int:
        """Ranks along ``axis``; 1 for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return 1
        return int(self.devices.shape[self.axis_names.index(axis)])

    def coords(self) -> Tuple[int, ...]:
        """This rank's position on the grid."""
        me = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == me)
        if len(where) == 0:
            raise ValueError(f"rank {me} is not on the mesh "
                             f"{self.devices.tolist()}")
        return tuple(int(i) for i in where[0])

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return self.coords()[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The group of this rank's line along ``axis``; ``None`` without a
        process group or for an absent axis."""
        if self.device_mesh is None or axis not in self.axis_names:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the process group's ranks (``devices``: a subset of them,
    in order; all of them by default).

    ``shape`` may hold one ``-1``, which absorbs the ranks the other axes
    leave, so ``(-1,)`` is pure data parallelism over every rank. Without a
    process group the world is one rank and no group is started. A shape
    that needs more ranks than there are raises ``ValueError``.
    """
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    ranks = list(range(world)) if devices is None else [int(d) for d in
                                                         devices]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    shape = [int(s) for s in shape]
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {tuple(shape)}: at most one -1")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = max(len(ranks) // known, 1)
    n = int(np.prod(shape))
    if n > len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks; there "
                         f"are {len(ranks)}")
    grid = np.asarray(ranks[:n]).reshape(shape)
    if not initialized:
        return Mesh(grid, tuple(axes))
    cuda = dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device("cpu"))
    return Mesh(grid, tuple(axes), device, DeviceMesh(
        device.type, torch.from_numpy(grid), mesh_dim_names=tuple(axes)))


Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``spec[d]``: the mesh axis that splits dimension ``d`` into equal
    blocks, or ``None``; dimensions past the spec are whole."""

    mesh: Mesh
    spec: Spec = ()

    def local(self, x):
        """This rank's block of ``x`` (a view; a tensor or an array)."""
        for d, axis in enumerate(self.spec):
            n = self.mesh.size(axis) if axis is not None else 1
            if n == 1:
                continue
            k = x.shape[d] // n
            lo = self.mesh.rank(axis) * k
            x = x[(slice(None),) * d + (slice(lo, lo + k),)]
        return x


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch) dimension split over ``axis``, the rest whole."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` (repeating row 0) to a multiple; returns
    (padded, original_len)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    pad_block = np.take(x, [0] * pad, axis=axis)
    return np.concatenate([x, pad_block], axis=axis), n
