"""Temporal landmark tracking: the 3-stage matcher as one masked window op.

Replaces the tracking engine of ``CFundamentalMatcher``
(CFundamentalMatcher.cpp:391-2397). The reference runs, per landmark, a
try/catch cascade of three stages:
  stage 1 — direct reprojection descriptor check (cutoff 25, :391-487);
  stage 2 — regional GFTT + brute-force recovery   (cutoff 50, :495-727);
  stage 3 — recursive epipolar-curve sampling      (cutoff 50, :2142-2397),
with search windows scaled by principal-point weight and motion and a
dual-descriptor acceptance (distance to the *last* AND to the *original*
descriptor).

Here the cascade is ONE dense scoring of the ``WIN_H x WIN_W`` window around
each landmark's predicted reprojection (ops.track_kernel: the CUDA kernel on
the card, ``window_scores`` as its plain version), whose score bias enforces
the cascade priority, followed by a stereo re-match of the winner.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.frontend.epipolar import (
    epipolar_band_params,
    fixed_band_params,
)
from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.mapping.landmarks import (
    LandmarkTable,
    anchor_descriptors,
)
from svi_mapper_tpu_torch.ops.descriptors import brief_at
from svi_mapper_tpu_torch.ops.track_kernel import (  # noqa: F401
    BIG,
    REACH_X,
    REACH_Y,
    TIER_BIAS,
    WIN_H,
    WIN_W,
    tier_scores,
    track_scores,
    window_scores,
)


@dataclasses.dataclass
class TrackResult:
    tracked: torch.Tensor      # [L] bool — matched this frame (left + right)
    uv4: torch.Tensor          # [L, 4] (uL, vL, uR, vR)
    desc_left: torch.Tensor    # [L, 8] descriptor at the matched left location
    p_cam: torch.Tensor        # [L, 3] instantaneous stereo triangulation
    depth: torch.Tensor        # [L]
    tier: torch.Tensor         # [L] int32 — which stage matched (0/1/2)
    distance: torch.Tensor     # [L] Hamming distance (to last descriptor)
    uv_pred: torch.Tensor      # [L, 2] predicted left reprojection


def track_landmarks(
    dense_left: torch.Tensor,      # [H, W, 8] dense BRIEF of current LEFT
    dense_right: torch.Tensor,     # [H, W, 8] dense BRIEF of current RIGHT
    table: LandmarkTable,
    T_wc_prior: torch.Tensor,      # [4,4] predicted world->LEFT-camera
    cam: StereoCamera,
    motion_scaling: torch.Tensor | float = 1.0,
    *,
    cutoff_s1: int = 25,        # ref CFundamentalMatcher.cpp:23
    cutoff_s2: int = 50,        # ref :24-26 (stage2 + epipolar)
    cutoff_ref: int = 50,       # vs the original descriptor (ref _getMatch)
    cutoff_stereo: int = 100,   # right-image re-match (ref CTriangulator.cpp:13)
    max_disparity: int = 128,
    use_epipolar: bool = True,  # False = legacy fixed horizontal band
    use_desc_history: bool = True,  # anchor the ref gate on the history ring
) -> TrackResult:
    """Track every active landmark into the current stereo frame."""
    # The "original"-descriptor side of the dual gate: the creation
    # descriptor, or the nearest history-ring snapshot. Resolved per
    # landmark BEFORE scoring, so the scorer consumes one [L, 8] anchor.
    desc_anchor = (anchor_descriptors(table) if use_desc_history
                   else table.desc_left_ref)

    L = table.capacity
    pos_w = table.pos_w
    p_c = se3.transform(T_wc_prior, pos_w)                 # [L, 3]
    uv_pred = cam.left.project(p_c)                        # [L, 2]
    in_front = p_c[:, 2] > 0.05
    in_view = cam.left.in_fov(uv_pred) & in_front

    if use_epipolar:
        band = epipolar_band_params(
            table, T_wc_prior, cam.left, uv_pred, motion_scaling,
            reach_x=REACH_X, reach_y=REACH_Y,
        )
    else:
        band = fixed_band_params(L, REACH_X, REACH_Y, device=pos_w.device)

    uvs = torch.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    frac = uvs - torch.round(uvs)

    best_score, x, y, best_dist = track_scores(
        dense_left, uv_pred, table.desc_left_last, desc_anchor, band,
        cutoff_s1=cutoff_s1, cutoff_s2=cutoff_s2, cutoff_ref=cutoff_ref,
    )

    uv_l = torch.stack([x.to(uv_pred.dtype), y.to(uv_pred.dtype)], dim=-1) + frac
    best_tier = torch.clamp(best_score // 1000, 0, 2)

    left_ok = (best_score < BIG) & in_view & table.active
    # descriptor at the matched pixel (round(uv_l) is exactly that pixel:
    # the carried fractional part is < 0.5 by construction)
    desc_new = brief_at(dense_left, uv_l)

    # right-image correspondence around the last disparity
    # (ref CTriangulator bounded search, CTriangulator.h:20-21)
    sm = match_stereo(
        dense_right, uv_l, desc_new, left_ok, cam,
        max_disparity=max_disparity,
        cutoff=cutoff_stereo,
        disparity_center=table.disparity_last,
        search_range=torch.clamp(0.5 * table.disparity_last, min=20.0),
    )
    tracked = left_ok & sm.ok
    uv4 = torch.cat([uv_l, sm.uv_right], dim=-1)
    return TrackResult(
        tracked=tracked,
        uv4=uv4,
        desc_left=desc_new,
        p_cam=sm.p_cam,
        depth=sm.depth,
        tier=best_tier,
        distance=best_dist,
        uv_pred=uv_pred,
    )
