"""The yardstick of the observation-list route's Schur assembly
(``svi_mapper_tpu_torch/solvers/ba.py``, windows past 128 keyframes): the
work it must do on one map and the card's published peaks, frozen here so
that the roofline share means the same in every later measurement,
whatever implements the route.

Operations are ``schur_work``'s (``portbench/work/schur.py``): per
observation the assembly's shared body, ``C = W Hll^-1`` and the rhs
column; per co-visible block (a landmark and two of its keyframes, the
pair of one keyframe with itself included) 216. Bytes: the inputs and the
lists read once (per observation its four coordinates and weight as
float32 and its keyframe and landmark as int32; per co-visible block its
two observations as int32; the poses and landmarks), the outputs written
once (``S``, ``rhs``, the landmarks' ``Hll^-1`` and ``b_l``, the
observations' ``W`` blocks), all float32.
"""

from __future__ import annotations

import torch

from portbench.work.schur import PEAK_BYTES_PER_S, PEAK_FLOPS_F32, SCHUR_FLOPS_PER_OBSERVATION

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FLOPS_F32", "bound_seconds", "obs_schur_work"]


def obs_schur_work(mask, K: int, L: int) -> dict:
    """The assembly of one ``[K, L]`` map through the lists."""
    n_l = (torch.as_tensor(mask) != 0).sum(0).to(torch.int64)
    n_obs = int(n_l.sum())
    pairs = int((n_l * (n_l + 1) // 2).sum())
    moved_in = 4 * (16 * K + 3 * L) + 28 * n_obs + 8 * pairs
    moved_out = 4 * (36 * K * K + 6 * K + 12 * L + 18 * n_obs)
    return dict(bytes=moved_in + moved_out,
                flops=n_obs * (SCHUR_FLOPS_PER_OBSERVATION + 90 + 36) + 216 * pairs,
                observations=n_obs, pairs=pairs)


def bound_seconds(work: dict) -> float:
    """The least time the card could take: operations at the float32 peak
    or bytes at the memory peak, whichever is longer."""
    return max(work["flops"] / PEAK_FLOPS_F32, work["bytes"] / PEAK_BYTES_PER_S)
