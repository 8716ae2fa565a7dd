"""Meshes over a ``torch.distributed`` process group (the port's
``repro.launch.mesh``).

``init_distributed`` starts the process group of this process: NCCL for
the card, gloo for the CPU; ``init_method`` is ``env://`` (what
``torchrun`` sets: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) or a ``file://`` path that every rank shares.
``make_mesh(shape, axes)`` lays the group's ranks out row-major over named
axes, as the reference's ``make_mesh`` lays out its devices.  A
:class:`Mesh` gives, for a tuple of its axes, the process group of the
ranks that differ only along them, this rank's index in that group (the
axes taken major to minor, as the reference's ``shard_map`` shards a dim
over them) and the global rank at a given index.

``make_production_mesh`` (the reference's 256- and 512-chip TPU meshes)
waits for the AOT slice, ROADMAP A.15.5.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start this process's process group and return its device.

    ``device`` is resolved as every entry point resolves it (the card
    unless ``"cpu"`` is asked).  On the card each rank takes the card of
    its ``LOCAL_RANK`` (``torchrun``'s), else of its rank modulo the cards.
    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``.
    """
    device = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return device


class Mesh:
    """The process group's ranks, row-major over named axes."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device):
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.device = device
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names,
                               np.unravel_index(self.rank, sizes)))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes``, the first axis major."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + int(self.coords[a])
        return i

    def global_rank(self, axes: Sequence[str], index: int) -> int:
        """The global rank of the member of this rank's ``axes`` group at
        ``index`` (the other axes' coordinates are this rank's)."""
        coords = dict(self.coords)
        for a in reversed(tuple(axes)):
            index, coords[a] = divmod(index, self.shape[a])
        return int(np.ravel_multi_index(
            [coords[a] for a in self.axis_names],
            tuple(self.shape.values())))

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's
        coordinates off ``axes`` (the default group when that is every
        rank).  Every rank must ask for the same axes in the same order:
        a group is made by all ranks together."""
        axes = tuple(axes)
        if axes not in self._groups:
            if self.size(axes) == self.world:
                self._groups[axes] = dist.group.WORLD
            else:
                self._groups[axes] = self._new_groups(axes)
        return self._groups[axes]

    def _new_groups(self, axes):
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            ranks = []
            for idx in range(self.size(axes)):
                coords = dict(zip(others, fixed))
                for a in reversed(axes):
                    idx, coords[a] = divmod(idx, self.shape[a])
                ranks.append(int(np.ravel_multi_index(
                    [coords[a] for a in self.axis_names],
                    tuple(self.shape.values()))))
            pg = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = pg
        return mine

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world}, "
                f"{self.device})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    """A mesh of the initialized process group's ranks: ``shape`` must
    multiply to its world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch.mesh.init_distributed)")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         f"in length")
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(shape, axes, torch.device(device))
