"""Epipolar-row stereo correspondence on the dense descriptor field.

Replaces ``CTriangulator`` (CTriangulator.cpp:13-356): the reference
generates a dense row of candidate keypoints along the rectified scanline in
RIGHT, extracts BRIEF for each, and brute-force Hamming-matches (cutoff 100,
search range bounded by the last disparity or 60 px, depth from disparity
with a min-disparity floor). Here the right image's descriptors are
precomputed densely once, so the scanline search is one Hamming profile per
keypoint followed by a masked argmin (fused in one kernel on the card:
ops.stereo_kernel.stereo_match) and a sub-pixel parabola, for all
keypoints at once.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.ops.stereo_kernel import _BIG, stereo_match


@dataclasses.dataclass
class StereoMatches:
    uv_right: torch.Tensor    # [K, 2]
    disparity: torch.Tensor   # [K]
    depth: torch.Tensor       # [K]
    p_cam: torch.Tensor       # [K, 3] triangulated camera-frame points
    distance: torch.Tensor    # [K] Hamming distance of the accepted match
    ok: torch.Tensor          # [K] bool


def match_stereo(
    dense_right: torch.Tensor,     # [H, W, 8] int32 dense BRIEF of RIGHT
    uv_left: torch.Tensor,         # [K, 2] left keypoints
    desc_left: torch.Tensor,       # [K, 8] their descriptors
    valid: torch.Tensor,           # [K] bool
    cam: StereoCamera,
    *,
    max_disparity: int = 128,
    cutoff: int = 100,             # ref CTriangulator.cpp:13
    min_disparity: float = 0.5,
    min_depth: float = 0.05,
    max_depth: float = 1000.0,
    disparity_center: torch.Tensor | None = None,  # [K] previous disparity
    search_range: torch.Tensor | None = None,      # [K] +- px around center
) -> StereoMatches:
    """Match left keypoints into the right image along rectified scanlines.

    When ``disparity_center``/``search_range`` are given the candidate set is
    masked to ``|d - center| <= range`` — the reference's bounded re-search
    around the last disparity (CTriangulator.h:20-21).

    ``ok`` encodes what the reference signalled with CExceptionNoMatchFound
    / CExceptionZeroDisparity.
    """
    dt = uv_left.dtype
    # the scanline search over the De candidates left of the keypoint, in
    # ascending-disparity order: the first masked minimum and its two
    # neighbours (the fused CUDA kernel on the card; ops.stereo_kernel)
    best, best_dist, dm, dp, u_r, x0 = stereo_match(
        dense_right, uv_left, desc_left, max_disparity=max_disparity,
        min_disparity=min_disparity, disparity_center=disparity_center,
        search_range=search_range)
    S = min(max_disparity, dense_right.shape[1])
    # disparity of profile index i: u = x0 + (S-1) - i, d = u_r - u
    disparity = (u_r - x0 - (S - 1)).to(dt) + best.to(dt)

    # sub-pixel refinement: 3-point parabola on the Hamming profile
    denom = (dm + dp - 2 * best_dist).to(dt)
    interior = (best > 0) & (best < S - 1)
    delta = torch.where(
        interior & (denom > 0) & (dm < _BIG) & (dp < _BIG),
        0.5 * (dm - dp).to(dt) / torch.clamp(denom, min=1e-6),
        torch.zeros_like(denom),
    )
    disparity = disparity + torch.clamp(delta, -0.5, 0.5)

    depth = cam.depth_from_disparity(disparity)
    uv_right = torch.stack([uv_left[:, 0] - disparity, uv_left[:, 1]], dim=-1)
    p_cam = cam.triangulate(uv_left, uv_right)

    ok = (
        valid
        & (best_dist <= cutoff)
        & (disparity >= min_disparity)
        & (depth > min_depth)
        & (depth < max_depth)
    )
    return StereoMatches(
        uv_right=uv_right,
        disparity=disparity,
        depth=depth,
        p_cam=p_cam,
        distance=best_dist,
        ok=ok,
    )
