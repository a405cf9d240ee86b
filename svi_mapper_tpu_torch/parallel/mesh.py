"""Device meshes and the placements of the SLAM state.

The reference is strictly single-process (SURVEY.md §2.9); this layer is
new capability. The pipeline's natural data parallelism is over landmark
table rows (tracking, measurement updates, per-landmark GN) and map blocks
(BA): the landmark axis shards over a 1-D ``map`` mesh dimension, and
images, poses and scalars replicate. The placements are DTensor ones:
``Shard(0)`` for every leaf of the landmark table, ``Replicate()`` for the
rest. Nothing partitions the eager frame step by itself here (ROADMAP,
queue 3); the sharded BA reduces its Schur system explicitly
(:mod:`parallel.sharded_ba`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from svi_mapper_tpu_torch.mapping.landmarks import LandmarkTable
from svi_mapper_tpu_torch.models.frame import FrameState
from svi_mapper_tpu_torch.utils.device import resolve_device


def make_map_mesh(n_devices: int | None = None,
                  device: torch.device | str | None = None) -> DeviceMesh:
    """1-D mesh over the ``map`` dimension: ranks ``0 .. n_devices - 1``
    (default: every rank of the process group)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(resolve_device(device).type, torch.arange(n), mesh_dim_names=("map",))


def table_shardings(mesh: DeviceMesh) -> LandmarkTable:
    """A LandmarkTable of placements: every per-landmark tensor splits its
    leading (landmark) axis over ``map``."""
    return LandmarkTable(**{f.name: (Shard(0),)
                            for f in dataclasses.fields(LandmarkTable)})


def state_shardings(mesh: DeviceMesh, state: FrameState) -> FrameState:
    """Placements for a whole FrameState: the table's tensors split over
    ``map``, poses and scalars replicated."""
    rep = (Replicate(),)
    return state.replace(**{f.name: rep for f in dataclasses.fields(FrameState)
                            if f.name != "table"},
                         table=table_shardings(mesh))


def shard_state(state: FrameState, mesh: DeviceMesh) -> FrameState:
    """The state as DTensors on ``mesh``: the table's rows split over
    ``map``, the rest replicated."""
    placements = state_shardings(mesh, state)

    def put(obj, place):
        return dataclasses.replace(obj, **{
            f.name: distribute_tensor(getattr(obj, f.name), mesh, getattr(place, f.name))
            for f in dataclasses.fields(obj) if f.name != "table"})

    return put(state, placements).replace(table=put(state.table, placements.table))


def replicate(x, mesh: DeviceMesh):
    """Replicate a tensor (an image, a pose) over the mesh."""
    return distribute_tensor(x, mesh, (Replicate(),))
