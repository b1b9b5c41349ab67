"""Meshes of named axes over ``torch.distributed`` ranks (the port of
``repro/launch/mesh.py``).

A ``Mesh`` is an ordered ``shape`` (axis name -> size) and ``devices``, an
array of that shape holding global ranks (row-major: the last axis varies
fastest, as in the reference's ``jax.make_mesh``). Planning reads only the
shape, so ``make_production_mesh`` gives the reference's 16 x 16 and
2 x 16 x 16 meshes as planning shapes with no process behind them.
``make_smoke_mesh`` reads the initialized world, and is one rank when no
process group exists. Where a process group exists, ``Mesh.group`` gives
an axis's (or a tuple of axes') sub-group: one axis through
``torch.distributed.device_mesh.init_device_mesh``, several through one
``new_group`` per slice.

``init_distributed`` starts a rank with the backend its layout needs:
``nccl`` where each rank has a card of its own, ``gloo`` on the CPU and
where ranks share a card (NCCL refuses two ranks on one device). Nothing
switches between them silently: ``repro_torch.parallel.collectives`` moves
CUDA tensors through host memory on every ``gloo`` call.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Named axes over global ranks. ``shape`` keeps the axes' order."""

    def __init__(self, shape: Mapping[str, int], devices=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        n = math.prod(self.shape.values())
        self.devices = np.arange(n).reshape(tuple(self.shape.values())) \
            if devices is None else np.asarray(devices)
        self._device_mesh = None
        self._groups: dict[tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def live(self) -> bool:
        """Whether a process group runs behind every rank of the mesh."""
        return dist.is_initialized() and dist.get_world_size() == self.size

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh's ranks (on ``cuda`` under
        ``nccl``, else on ``cpu``), or ``None`` without a process group."""
        if not self.live:
            return None
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._device_mesh = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def coordinate(self, rank: int | None = None) -> dict[str, int]:
        """This rank's (or ``rank``'s) index along every axis."""
        rank = dist.get_rank() if rank is None and self.live else (rank or 0)
        where = np.argwhere(self.devices == rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def axes_index(self, axes: str | Sequence[str] | None,
                   rank: int | None = None) -> int:
        """This rank's position along ``axes`` taken together, the first
        axis the most significant (a ``PartitionSpec`` tuple's order)."""
        if axes is None:
            return 0
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coord = self.coordinate(rank)
        index = 0
        for a in axes:
            index = index * self.shape[a] + coord[a]
        return index

    def group(self, axes: str | Sequence[str]):
        """The process group of this rank's slice along ``axes`` (one axis
        name or a tuple). Every rank must ask for the same groups in the
        same order, as for any ``torch.distributed`` group."""
        if not self.live:
            raise RuntimeError(f"{self} has no process group behind it")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                self._groups[axes] = self._new_groups(axes)
        return self._groups[axes]

    def _new_groups(self, axes: tuple[str, ...]):
        """One ``new_group`` per slice along ``axes`` (every rank creates
        every slice's group, in the same order); this rank's is returned."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = np.transpose(self.devices, rest + keep).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        mine, me = None, dist.get_rank()
        for ranks in grid:
            g = dist.new_group([int(r) for r in ranks])
            if me in ranks:
                mine = g
        return mine


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes as planning shapes: 16 x 16
    (``data``, ``model``), or 2 x 16 x 16 (``pod``, ``data``, ``model``)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_smoke_mesh(model: int = 1) -> Mesh:
    """``data`` x ``model`` over the initialized world (one rank without a
    process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({"data": n // model, "model": model})


def mesh_devices(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def pick_backend(world_size: int, device: str) -> str:
    """``nccl`` where each of ``world_size`` ranks has a card of its own,
    else ``gloo`` (the CPU, or ranks sharing a card)."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA layout on a machine without a card")
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: str = "cuda") -> str:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``) with
    the backend ``pick_backend`` names; on ``cuda`` the rank's card is
    ``rank % device_count``. Returns the backend."""
    backend = pick_backend(world_size, device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend
