"""Distributed bundle adjustment: landmark-sharded Schur reduction.

BASELINE.json configs 4-5: "large-map distributed BA: keyframe/map-block
partitioned Schur reduction on a multi-chip mesh". The reference has no
distributed anything (SURVEY.md §2.9); this layer is new capability.

Design: every rank holds the whole problem and takes one contiguous shard
of the landmark axis (observations ``[K, L/n, 4]``, landmarks ``[L/n, 3]``).
Each rank assembles the Schur system of its shard, ``S_r = H_pp,r - sum over
its l of W_l H_ll^-1 W_l^T`` and ``rhs_r`` (kernel K4 / K5 on the card, the
plain version on the CPU), and one ``all_reduce(SUM)`` over the ``map``
group gives every rank the whole system, as XLA's one ``psum`` does in the
JAX package. Damping, the odometry and gravity terms, gauge fixing and the
Cholesky solve of the small ``[6K, 6K]`` system then run identically on
every rank; back-substitution stays local to the shard. The landmark part
of chi^2 is summed the same way, so every rank takes the same LM decisions.

The solver body is the SAME ``solvers.ba.bundle_adjust``: this module only
cuts the data and passes the reduction (its ``_landmark_sum`` hook). One
code path, any mesh size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.solvers import ba as ba_mod
from svi_mapper_tpu_torch.utils.device import resolve_device


def landmark_sum(group):
    """The ``_landmark_sum`` hook for ``group``: the given tensors summed
    over its ranks through ONE ``all_reduce`` of their concatenation."""

    def reduce(*tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at: at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    return reduce


def shard_ba_inputs(
    mesh: DeviceMesh,
    T_wc: torch.Tensor,
    points_w: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_mask: torch.Tensor,
    fix_mask: torch.Tensor,
):
    """The BA inputs as DTensors on ``mesh``: the landmark axis over
    ``map`` (``points_w`` along its rows, ``obs_uv`` and ``obs_mask`` along
    L, their axis 1), ``T_wc`` and ``fix_mask`` replicated. Every rank
    passes the same whole problem; L must split evenly (pad it first, as
    :func:`bundle_adjust_sharded` does; ``ValueError`` otherwise)."""
    n = mesh.size()
    if points_w.shape[0] % n:
        raise ValueError(f"{points_w.shape[0]} landmarks do not split over {n} ranks")
    rep, lnd, k_lnd = (Replicate(),), (Shard(0),), (Shard(1),)
    return (
        distribute_tensor(T_wc, mesh, rep),
        distribute_tensor(points_w, mesh, lnd),
        distribute_tensor(obs_uv, mesh, k_lnd),
        distribute_tensor(obs_mask, mesh, k_lnd),
        distribute_tensor(fix_mask, mesh, rep),
    )


def bundle_adjust_sharded(
    mesh: DeviceMesh,
    T_wc: torch.Tensor,
    points_w: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_mask: torch.Tensor,
    cam: StereoCamera,
    fix_mask: torch.Tensor,
    device: torch.device | str | None = None,
    obs_w: torch.Tensor | None = None,
    **kwargs,
) -> ba_mod.BAResult:
    """Schur-complement BA with the landmark axis sharded over ``mesh``.

    Every rank passes the same whole problem. The landmark axis is padded
    to a multiple of the mesh size (padded landmarks are unobserved); each
    rank solves with its shard, and the landmarks are gathered back, so
    every rank returns the whole result. Numerically the single-device
    solve with the landmark sums taken in another order. ``obs_w`` (``[K,
    L]``) is cut with the observations; ``kwargs`` (the per-keyframe
    odometry and gravity terms, the solver's options) pass through whole."""
    dev = resolve_device(device)
    group = mesh.get_group("map")
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    L = points_w.shape[0]
    pad = (-L) % n
    points_w = torch.as_tensor(points_w, device=dev)
    obs_uv = torch.as_tensor(obs_uv, device=dev)
    obs_mask = torch.as_tensor(obs_mask, device=dev)
    if obs_w is not None:
        obs_w = torch.as_tensor(obs_w, device=dev)
    if pad:
        points_w = F.pad(points_w, (0, 0, 0, pad))
        obs_uv = F.pad(obs_uv, (0, 0, 0, pad))
        obs_mask = F.pad(obs_mask, (0, pad))
        if obs_w is not None:
            obs_w = F.pad(obs_w, (0, pad))
    per = (L + pad) // n
    mine = slice(rank * per, (rank + 1) * per)
    res = ba_mod.bundle_adjust(
        T_wc, points_w[mine], obs_uv[:, mine], obs_mask[:, mine], cam, fix_mask,
        device=dev, obs_w=None if obs_w is None else obs_w[:, mine],
        _landmark_sum=landmark_sum(group), **kwargs)
    shards = [torch.empty_like(res.points_w) for _ in range(n)]
    dist.all_gather(shards, res.points_w.contiguous(), group=group)
    return ba_mod.BAResult(
        T_wc=res.T_wc, points_w=torch.cat(shards)[:L],
        chi2_initial=res.chi2_initial, chi2_final=res.chi2_final,
        iterations=res.iterations)
