"""Multi-process runtime on ``torch.distributed``: process-group bring-up
and pod meshes.

The reference has no distributed backend at all (single process, SURVEY.md
§2.9). This is the port's thin, testable bring-up layer, one rank per
device:

* :func:`initialize` — ``torch.distributed.init_process_group`` over a TCP
  rendezvous, a no-op in single-process runs (the same entry point works on
  one card and on several hosts launched with the coordinator environment);
* :func:`make_pod_mesh` — a ``(host, map)`` device mesh over consecutive
  ranks: the landmark axis shards within a host, keyframe blocks across
  hosts;
* :func:`host_local_slice` — which rows of a ``map``-sharded landmark axis
  belong to this rank's host (for host-side IO like checkpoint writes).

The sharded Schur BA is :mod:`parallel.sharded_ba`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from svi_mapper_tpu_torch.utils.device import resolve_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> bool:
    """Join the process group; returns True if it holds more than one
    process.

    With no arguments, reads ``COORDINATOR_ADDRESS`` (``host:port``),
    ``NUM_PROCESSES`` and ``PROCESS_ID`` from the environment, and stays
    single-process, initialising nothing, when none is set. The backend
    follows ``device`` (``None`` means CUDA, as everywhere in the port):
    ``nccl`` for a CUDA device, whose rank ``r`` then takes card
    ``r % device_count``, and ``gloo`` for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number "
            "of processes and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def make_pod_mesh(
    hosts: int | None = None,
    axis_names: tuple[str, str] = ("host", "map"),
    device: torch.device | str | None = None,
) -> DeviceMesh:
    """2-D ``(host, map)`` mesh over every rank of the process group.

    Rank ``r`` sits at row ``r // (world / hosts)``: each row is one host's
    consecutive ranks, so collectives over ``map`` stay within a host and
    those over ``host`` cross hosts. ``hosts`` defaults to the world size
    over the devices one host holds (the CUDA device count, 1 for the CPU)."""
    kind = resolve_device(device).type
    world = dist.get_world_size()
    local = torch.cuda.device_count() if kind == "cuda" else 1
    n_hosts = hosts or max(world // max(local, 1), 1)
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    grid = torch.arange(world).reshape(n_hosts, world // n_hosts)
    return DeviceMesh(kind, grid, mesh_dim_names=axis_names)


def host_local_slice(global_rows: int, mesh: DeviceMesh) -> slice:
    """Rows of a ``map``-sharded axis owned by this rank's host."""
    n_hosts = mesh.mesh.shape[0]
    per = -(-global_rows // n_hosts)
    host = mesh.get_coordinate()[0]
    return slice(host * per, min((host + 1) * per, global_rows))
