"""Regional detection recovery — the batched stage-2 second chance.

Replaces the reference's regional GFTT recovery
(CFundamentalMatcher.cpp:495-727): for every landmark the direct window
check missed, the reference re-detects corners inside a search rectangle
around the predicted reprojection — half size
``round(principal_weight + motion_scaling) * 15`` px per axis — brute-force
Hamming-matches the landmark's last descriptor against the region's corner
descriptors (cutoff 50), and stereo-triangulates the winner.

The loop is inverted: corners are detected ONCE over the whole image,
descriptors of all detections are gathered in one batch, and the
landmark-region containment + Hamming acceptance is one ``[L, K]`` masked
matrix reduced by argmin. One-to-one assignment keeps, per detection, only
the landmark with the smallest distance (ties: lowest landmark index).
Recovery runs AFTER the pose solve, under the refined pose, and is skipped
when no landmark needs it — here a Python ``if`` on one host-read flag.

On a landmark-sharded table (``shards``) each rank recovers its own rows
against the same detections: the skip flag is summed over the ranks before
it is read (a rank that skipped would leave the others waiting in a
collective), and the one-to-one assignment takes its per-detection minima
over every rank's landmarks, by global row.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.mapping.landmarks import (
    LandmarkTable,
    anchor_descriptors,
)
from svi_mapper_tpu_torch.ops.corners import detect_corners
from svi_mapper_tpu_torch.ops.descriptors import brief_at
from svi_mapper_tpu_torch.ops.hamming import hamming_mxu

_BIG = 1 << 20

# region half-size unit (ref m_uSearchBlockSizePoseOptimization = 15,
# CFundamentalMatcher.h:95)
SEARCH_BLOCK_PX = 15.0

# the 3x3 neighbourhood scored around every detected corner
_OFFSETS = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
            (1, 1), (1, -1), (-1, 1), (-1, -1)]


@dataclasses.dataclass
class RecoveryResult:
    recovered: torch.Tensor    # [L] bool — recovered this frame (left + right)
    uv4: torch.Tensor          # [L, 4] stereo measurement of recovered landmarks
    desc_left: torch.Tensor    # [L, 8] descriptor at the recovered left corner
    n_candidates: torch.Tensor  # int32 — landmarks that needed recovery


def regional_recovery(
    dense_left: torch.Tensor,      # [H, W, 8] dense BRIEF of current LEFT
    dense_right: torch.Tensor,
    img_left: torch.Tensor,        # [H, W] float32 (unpadded) for detection
    table: LandmarkTable,
    tracked: torch.Tensor,         # [L] bool — already matched by the window pass
    T_wc: torch.Tensor,            # [4,4] REFINED world->LEFT-camera pose
    cam: StereoCamera,
    ms: torch.Tensor | float,      # motion scaling (ref CTrackerGT.cpp:157)
    *,
    cutoff: int = 50,           # ref m_dMatchingDistanceCutoffTrackingStage2
    cutoff_stereo: int = 100,   # right-image re-match (ref CTriangulator.cpp:13)
    max_detections: int = 1024,
    detect_cell: int = 4,
    detect_quality: float = 0.01,
    use_desc_history: bool = True,
    shards=None,
) -> RecoveryResult:
    """Recover un-tracked landmarks from freshly detected corners."""
    L = table.capacity
    dt = table.pos_w.dtype
    dev = table.device

    # --- who needs recovery, and where ------------------------------------
    p_c = se3.transform(T_wc, table.pos_w)                  # [L, 3]
    uv_pred = cam.left.project(p_c)
    in_front = p_c[:, 2] > 0.05
    in_view = cam.left.in_fov(uv_pred) & in_front
    need = table.active & ~tracked & in_view

    # per-landmark region half sizes (ref .cpp:499-503)
    pw = cam.left.principal_weight(
        torch.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0))
    scale = torch.round(pw + torch.as_tensor(ms, dtype=dt, device=dev))
    half = scale * SEARCH_BLOCK_PX                          # (hw, hh)

    n_need = torch.sum(need.to(torch.int32))
    if shards is not None:
        (n_need,) = shards.sum(n_need)

    # The reference only runs stage 2 for MISSED landmarks; on frames where
    # the window pass tracked everything the full-image corner pass is pure
    # waste. One host read of the flag decides.
    if int(n_need) == 0:
        return RecoveryResult(
            recovered=torch.zeros((L,), dtype=torch.bool, device=dev),
            uv4=torch.zeros((L, 4), dtype=dt, device=dev),
            desc_left=torch.zeros_like(table.desc_left_last),
            n_candidates=torch.zeros((), dtype=torch.int32, device=dev),
        )
    return _recover(
        dense_left, dense_right, img_left, table, need, half, uv_pred,
        cam, cutoff=cutoff, cutoff_stereo=cutoff_stereo,
        max_detections=max_detections, detect_cell=detect_cell,
        detect_quality=detect_quality, use_desc_history=use_desc_history,
        n_need=n_need, shards=shards,
    )


def _recover(
    dense_left, dense_right, img_left, table, need, half, uv_pred, cam, *,
    cutoff, cutoff_stereo, max_detections, detect_cell, detect_quality,
    use_desc_history, n_need, shards,
) -> RecoveryResult:
    L = table.capacity
    dt = table.pos_w.dtype
    dev = table.device

    # --- one full-image detection (the reference's per-region GFTT), with a
    #     finer NMS cell than new-landmark detection: recovery needs the
    #     corner nearest the old feature, not a spread-out constellation ---
    uv_c, _, valid_c = detect_corners(
        img_left, k=max_detections, cell=detect_cell,
        quality=detect_quality, border=28,
    )
    # BRIEF decorrelates within ~2 px and corner localization shifts a few
    # px between views — score each corner's 3x3 neighbourhood so the
    # landmark can re-anchor on the exact pixel
    offs = torch.tensor(_OFFSETS, dtype=dt, device=dev)
    uv_det = (uv_c[:, None, :] + offs[None, :, :]).reshape(-1, 2)  # [K*9, 2]
    valid_det = torch.repeat_interleave(valid_c, offs.shape[0])
    desc_det = brief_at(dense_left, uv_det)                 # [K*9, 8]
    K = uv_det.shape[0]

    # --- [L, K] masked Hamming acceptance (bit-matmul: the XOR+popcount
    #     form would materialize [L, K, 8]); same dual gate as the window
    #     pass: last descriptor + anchor -----------------------------------
    desc_anchor = (anchor_descriptors(table) if use_desc_history
                   else table.desc_left_ref)
    d_last = hamming_mxu(table.desc_left_last, desc_det)    # [L, K]
    d_ref = hamming_mxu(desc_anchor, desc_det)

    du = uv_det[None, :, 0] - uv_pred[:, None, 0]           # [L, K]
    dv = uv_det[None, :, 1] - uv_pred[:, None, 1]
    in_region = (torch.abs(du) <= half[:, None, 0]) & (torch.abs(dv) <= half[:, None, 1])
    ok = (need[:, None] & valid_det[None, :] & in_region
          & (d_last <= cutoff) & (d_ref <= cutoff))
    cost = torch.where(ok, d_last, torch.full_like(d_last, _BIG))

    best_cost, best = torch.min(cost, dim=1)                # first minimum
    accept = best_cost < _BIG

    # one-to-one: per detection keep the lowest-cost claiming landmark
    # (ref vote dedup _getMatchNN, CTrackerGT.cpp:648-678)
    big = torch.full_like(best_cost, _BIG)
    det_best = torch.full((K,), _BIG, dtype=torch.int32, device=dev)
    det_best.scatter_reduce_(0, best, torch.where(accept, best_cost, big),
                             "amin", include_self=True)
    if shards is not None:
        det_best = shards.min(det_best)
    accept = accept & (det_best[best] == best_cost)
    # distance ties between two landmarks on one detection: keep the lowest
    # landmark index (matches the sequential reference order); the index is
    # the global row on a sharded table
    L_all, row0 = (L, 0) if shards is None else (L * shards.world, shards.offset(L))
    rows = torch.arange(row0, row0 + L, dtype=torch.int32, device=dev)
    first_l = torch.full((K,), L_all, dtype=torch.int32, device=dev)
    first_l.scatter_reduce_(0, best,
                            torch.where(accept, rows, torch.full_like(rows, L_all)),
                            "amin", include_self=True)
    if shards is not None:
        first_l = shards.min(first_l)
    accept = accept & (first_l[best] == rows)

    uv_l = uv_det[best]                                     # [L, 2]
    desc_l = desc_det[best]

    # --- stereo correspondence + depth gates (ref .cpp:556-575) ----------
    sm = match_stereo(
        dense_right, uv_l, desc_l, accept, cam,
        cutoff=cutoff_stereo,
        disparity_center=table.disparity_last,
        search_range=torch.clamp(0.5 * table.disparity_last, min=60.0),
    )
    recovered = accept & sm.ok
    uv4 = torch.cat([uv_l, sm.uv_right], -1)
    return RecoveryResult(
        recovered=recovered,
        uv4=uv4,
        desc_left=desc_l,
        n_candidates=n_need,
    )
