"""Device meshes, the placements of the SLAM state, and the collectives of
the landmark-sharded frame step.

The reference is strictly single-process (SURVEY.md §2.9); this layer is
new capability. The pipeline's natural data parallelism is over landmark
table rows (tracking, measurement updates, per-landmark GN) and map blocks
(BA): the landmark axis shards over a 1-D ``map`` mesh dimension, and
images, poses and scalars replicate. The placements are DTensor ones:
``Shard(0)`` for every leaf of the landmark table, ``Replicate()`` for the
rest.

The frame step (``models.frame.process_frame`` / ``process_chunk``) takes
the state :func:`shard_state` returns. It unwraps the DTensors once, runs
every op on this rank's own rows as plain tensors, and calls
:class:`LandmarkShards` exactly where the step reduces or selects across
the landmark axis (where XLA inserts a ``psum`` in the JAX package); on a
state on one device those calls are not made. Every exchange is an
``all_reduce`` (SUM / MIN / MAX), gathers included, so the same code runs
over NCCL and over gloo, whose CUDA support covers ``all_reduce``. The
sharded BA reduces its Schur system the same way
(:mod:`parallel.sharded_ba`).

A host read of a sharded state (a checkpoint, a cloud, a g2o snapshot,
the viewer's and the loggers' dumps) goes through :func:`host_arrays`,
which gathers every row: a collective that every rank must make. Where
such a read writes a file, rank 0 writes it and the ranks leave together
(:meth:`LandmarkShards.write_on_rank0`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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
    ``map``, the rest replicated. Every rank passes the same whole state
    and keeps its own contiguous block of rows (no data moves). The
    capacity must be a multiple of the mesh size (``ValueError``
    otherwise), as the JAX dry run rounds it."""
    shards = LandmarkShards(mesh)
    L = state.table.capacity
    if L % shards.world:
        raise ValueError(
            f"a table of {L} landmarks does not split over {shards.world} ranks")
    per = L // shards.world
    mine = slice(shards.rank * per, (shards.rank + 1) * per)
    table = state.table.replace(**{
        f.name: getattr(state.table, f.name)[mine]
        for f in dataclasses.fields(LandmarkTable)})
    return shards.wrap_state(state.replace(table=table))


def replicate(x, mesh: DeviceMesh):
    """Replicate a tensor (an image, a pose) over the mesh."""
    return distribute_tensor(x, mesh, (Replicate(),))


def _plain(x):
    return x.to_local() if isinstance(x, DTensor) else x


def host_arrays(*tensors) -> list[np.ndarray]:
    """Numpy copies of ``tensors`` with every element: a plain tensor's
    own (an array as it is), a ``Replicate()`` DTensor's local copy, and for a ``Shard(d)``
    DTensor every rank's rows in rank order, through ONE
    :meth:`LandmarkShards.gather` for all the sharded ones of a mesh and
    axis (every bit kept, NaN and -0.0 too). Never one rank's shard alone.

    A sharded read is a collective: every rank of the mesh must make it,
    with the same tensors in the same order, or the ranks that do wait out
    the group's timeout."""
    out: list = [None] * len(tensors)
    groups: dict = {}
    for i, x in enumerate(tensors):
        if isinstance(x, DTensor) and x.placements[0].is_shard():
            key = (id(x.device_mesh), x.placements[0].dim)
            groups.setdefault(key, []).append(i)
        elif torch.is_tensor(x):
            out[i] = _plain(x).detach().cpu().numpy()
        else:
            out[i] = np.asarray(x)
    for (_, dim), idx in groups.items():
        shards = LandmarkShards(tensors[idx[0]].device_mesh)
        full = shards.gather(*[tensors[i].to_local().detach() for i in idx], dim=dim)
        for i, t in zip(idx, full):
            out[i] = t.cpu().numpy()
    return out


class LandmarkShards:
    """This rank's view of a ``map``-sharded landmark table: which rows it
    holds, and the collectives the frame step calls where it crosses them.

    Every method is one ``all_reduce`` over the ``map`` group. A rank whose
    collective fails raises (``torch.distributed``'s error); no method runs
    anything unsharded in its place."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.group = mesh.get_group("map")
        self.world = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank("map")

    @staticmethod
    def of(rows) -> "LandmarkShards | None":
        """The shards of a tensor of table rows: its mesh's for a DTensor,
        None for a tensor on one device."""
        return LandmarkShards(rows.device_mesh) if isinstance(rows, DTensor) else None

    # --- placements --------------------------------------------------------
    local = staticmethod(_plain)

    def local_state(self, state: FrameState) -> FrameState:
        """The state with plain tensors: this rank's rows of the table, the
        replicated fields whole."""
        def unwrap(obj):
            return dataclasses.replace(obj, **{
                f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "table"})

        return unwrap(state).replace(table=unwrap(state.table))

    def wrap_rows(self, x: torch.Tensor, dim: int = 0) -> DTensor:
        """This rank's rows ``x`` as a DTensor split along ``dim``."""
        return DTensor.from_local(x, self.mesh, (Shard(dim),), run_check=False)

    def wrap_state(self, state: FrameState) -> FrameState:
        """The inverse of :meth:`local_state`: the placements of
        :func:`state_shardings`."""
        rep = (Replicate(),)
        table = state.table.replace(**{
            f.name: self.wrap_rows(getattr(state.table, f.name))
            for f in dataclasses.fields(LandmarkTable)})
        return state.replace(**{
            f.name: DTensor.from_local(getattr(state, f.name), self.mesh, rep,
                                       run_check=False)
            for f in dataclasses.fields(FrameState) if f.name != "table"},
            table=table)

    def write_on_rank0(self, write) -> None:
        """Call ``write()`` (a file write) on rank 0 alone; every rank must
        call this, and all return together once the file is whole, so a
        rank that reads it next finds it. One ``all_reduce`` carries rank
        0's outcome: if its write raised, every rank raises."""
        err = None
        if self.rank == 0:
            try:
                write()
            except Exception as e:  # noqa: BLE001  (re-raised below, after the ranks meet)
                err = e
        failed = self.any(torch.tensor([err is not None], device=self.mesh.device_type))
        if err is not None:
            raise err
        if bool(failed):
            raise RuntimeError("rank 0 of the map mesh failed to write its file")

    def offset(self, rows: int) -> int:
        """The global index of this rank's first row, ``rows`` per rank."""
        return self.rank * rows

    # --- collectives -------------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def sum(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Tensors of one dtype summed over the ranks through ONE
        ``all_reduce`` of their concatenation."""
        flat = self._all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                                dist.ReduceOp.SUM)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at: at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the ranks (a new tensor)."""
        return self._all_reduce(x.clone(), dist.ReduceOp.MIN)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise OR of a bool tensor over the ranks."""
        return self._all_reduce(x.to(torch.uint8), dist.ReduceOp.MAX).bool()

    def all(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise AND of a bool tensor over the ranks."""
        return self._all_reduce(x.to(torch.uint8), dist.ReduceOp.MIN).bool()

    def exclusive_prefix(self, count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(sum over the lower ranks, sum over all ranks)`` of a scalar
        count: each rank writes its count into its own entry of a zero
        ``[world]`` buffer, and one SUM gathers them."""
        buf = torch.zeros(self.world, dtype=count.dtype, device=count.device)
        buf[self.rank] = count
        self._all_reduce(buf, dist.ReduceOp.SUM)
        return torch.sum(buf[: self.rank]), torch.sum(buf)

    def gather(self, *tensors: torch.Tensor, dim: int = 0) -> list[torch.Tensor]:
        """Every rank's rows of each tensor along ``dim``, in rank order,
        through ONE SUM of a zero ``[world, bytes]`` buffer that holds each
        rank's bytes in its own row: adding zeros to a byte keeps it, so
        the result has the rows' exact bits (a float's sign of zero and its
        NaNs included)."""
        moved = [t.movedim(dim, 0).contiguous() for t in tensors]
        # flattened before the byte view: a contiguous tensor with a
        # dimension of size 1 may keep a stride other than 1 there
        parts = [(t.to(torch.uint8) if t.dtype == torch.bool else t).reshape(-1)
                 .view(torch.uint8) for t in moved]
        sizes = [p.numel() for p in parts]
        buf = torch.zeros((self.world, sum(sizes)), dtype=torch.uint8,
                          device=tensors[0].device)
        buf[self.rank] = torch.cat(parts)
        self._all_reduce(buf, dist.ReduceOp.SUM)
        out, at = [], 0
        for t, m, n in zip(tensors, moved, sizes):
            rows = buf[:, at: at + n].reshape((self.world,) + m.shape[:1] + (-1,))
            if t.dtype == torch.bool:
                full = rows.bool()
            else:
                full = rows.contiguous().view(t.dtype)
            full = full.reshape((self.world * m.shape[0],) + m.shape[1:])
            out.append(full.movedim(0, dim))
            at += n
        return out
