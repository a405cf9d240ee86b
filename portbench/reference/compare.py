"""The numbers by which an answer of the program is held to the
reference's: each a function of the program's answer and the reference's
solution of the same inputs, worst over the answers of a run. A cell's
limits file (``portbench/limits/<cell>.json``) names the numbers it
compares and their limits.

Poses are compared by camera centre (``-R^T t``, metres) and by the angle
between the rotations (from the skew part of ``R^T R_ref``, which keeps its
digits at small angles where ``acos`` of the trace does not)."""

from __future__ import annotations

import numpy as np


def _centres(T):
    R, t = T[:, :3, :3], T[:, :3, 3]
    return -np.einsum("kji,kj->ki", R, t)


def _angles(T, Tr):
    M = np.einsum("kji,kjl->kil", T[:, :3, :3], Tr[:, :3, :3])
    w = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                  M[:, 1, 0] - M[:, 0, 1]], -1) / 2
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0, 1))


def over_limits(nums: dict, limits: dict) -> list[str]:
    """The names in ``limits`` whose number in ``nums`` is not within its
    limit (a NaN is within none): an answer is correct when this is
    empty."""
    return [n for n in limits if not nums[n] <= limits[n]]


def numbers(ans: dict, ref: dict) -> dict:
    """Every number this module knows, for one answer. ``ans`` and ``ref``
    hold ``T [K,4,4]``, ``X [L,3]``, ``chi2`` and ``iterations``."""
    T, Tr = ans["T"].astype(np.float64), ref["T"]
    dc = np.linalg.norm(_centres(T) - _centres(Tr), axis=-1)
    dx = np.linalg.norm(ans["X"].astype(np.float64) - ref["X"], axis=-1)
    return {
        "iterations_gap": float(abs(int(ans["iterations"]) - int(ref["iterations"]))),
        "centre_gap_m": float(dc.max()),
        "rotation_gap_rad": float(_angles(T, Tr).max()),
        "landmark_gap_m": float(dx.max()),
        "chi2_gap": float(abs(float(ans["chi2"]) - ref["chi2"]) / max(ref["chi2"], 1e-30)),
    }
