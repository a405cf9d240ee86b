"""Shi-Tomasi corner detection with masked grid NMS and fixed-K output.

Replaces the reference's ``cv::GoodFeaturesToTrackDetector`` (1000
features, quality 0.01, min distance 7 — CFundamentalMatcher.cpp:18)
including the active-landmark exclusion mask (CFundamentalMatcher.cpp:2043).
The variable-length keypoint list becomes a fixed-capacity ``[K]`` table
with a validity mask:
  1. 3x3 local-maximum suppression on the min-eigenvalue response;
  2. one winner per ``cell x cell`` grid cell (first maximum);
  3. global top-K over cell winners, ties broken by lower index.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops.image import (
    _maxpool_separable,
    box_blur,
    sobel_gradients,
)


def min_eig_response(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Shi-Tomasi corner response: min eigenvalue of the structure tensor,
    ``(sxx + syy)/2 - sqrt(((sxx - syy)/2)^2 + sxy^2)``."""
    ix, iy = sobel_gradients(img)
    sxx = box_blur(ix * ix, window)
    syy = box_blur(iy * iy, window)
    sxy = box_blur(ix * iy, window)
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy, min=0.0))
    return half_tr - disc


def detect_corners(
    img: torch.Tensor,
    k: int = 1024,
    cell: int = 16,
    quality: float = 0.01,
    border: int = 28,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect up to ``k`` corners with grid-spread NMS.

    Args:
      img: [H, W] float32 image.
      k: output capacity (ref GFTT cap 1000).
      cell: grid cell size in px — lower bound on feature spacing.
      quality: relative quality level vs the best response (ref 0.01).
      border: exclusion border in px (ref FoV inset 28).
      mask: optional [H, W] bool — True where detection is ALLOWED.

    Returns:
      (uv [k, 2] float32 (u=x, v=y), score [k], valid [k] bool),
      sorted by descending score.
    """
    h, w = img.shape
    dev = img.device
    resp = min_eig_response(img)
    neg_inf = torch.full_like(resp, float("-inf"))

    # 3x3 local maximum test via separable shifted max
    neigh = _maxpool_separable(resp, 1)
    is_peak = resp >= neigh

    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    ok = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    if mask is not None:
        ok = ok & mask
    resp_masked = torch.where(is_peak & ok, resp, neg_inf)

    # quality gate relative to the global best, with a strict positive floor
    # so textureless images yield zero detections
    best = torch.max(resp_masked)
    floor = torch.clamp(quality * torch.clamp(best, min=0.0), min=1e-6)
    resp_masked = torch.where(resp_masked > floor, resp_masked, neg_inf)

    # one winner per grid cell
    ch = -(-h // cell)
    cw = -(-w // cell)
    padded = torch.full((ch * cell, cw * cell), float("-inf"),
                        dtype=resp.dtype, device=dev)
    padded[:h, :w] = resp_masked
    cells = padded.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
        ch, cw, cell * cell)
    # torch.max over a dim returns the FIRST maximal index, as jnp.argmax
    cell_best, cell_arg = torch.max(cells, dim=-1)
    cell_v = cell_arg // cell
    cell_u = cell_arg % cell
    vv = (torch.arange(ch, device=dev)[:, None] * cell + cell_v).reshape(-1)
    uu = (torch.arange(cw, device=dev)[None, :] * cell + cell_u).reshape(-1)
    scores = cell_best.reshape(-1)

    # global top-k over cell winners: a stable descending sort keeps the
    # lower index first among equal scores (torch.topk promises no order)
    k_eff = min(k, scores.shape[0])
    order = torch.sort(scores, descending=True, stable=True).indices[:k_eff]
    top_scores = scores[order]
    sel_u = uu[order].to(torch.float32)
    sel_v = vv[order].to(torch.float32)
    valid = torch.isfinite(top_scores)
    uv = torch.stack([sel_u, sel_v], dim=-1)
    if k_eff < k:
        n = k - k_eff
        uv = torch.cat([uv, torch.zeros((n, 2), dtype=uv.dtype, device=dev)])
        top_scores = torch.cat(
            [top_scores, torch.full((n,), float("-inf"), dtype=top_scores.dtype,
                                    device=dev)])
        valid = torch.cat([valid, torch.zeros((n,), dtype=torch.bool, device=dev)])
    uv = torch.where(valid[:, None], uv, torch.zeros_like(uv))
    return uv, torch.where(valid, top_scores, torch.zeros_like(top_scores)), valid


def occupancy_mask(
    shape: tuple[int, int], uv: torch.Tensor, valid: torch.Tensor, radius: int = 7
) -> torch.Tensor:
    """Detection-allowed mask that excludes boxes around existing features
    (replaces the reference's per-landmark ``cv::circle`` mask painting,
    CFundamentalMatcher.cpp:2043): True where detection is allowed."""
    h, w = shape
    occ = torch.zeros((h, w), dtype=torch.float32, device=uv.device)
    ui = torch.clamp(uv[:, 0].to(torch.int64), 0, w - 1)
    vi = torch.clamp(uv[:, 1].to(torch.int64), 0, h - 1)
    occ.index_put_((vi, ui), valid.to(torch.float32), accumulate=True)
    occ = _maxpool_separable(occ, radius)
    return occ <= 0.0
