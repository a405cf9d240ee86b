"""Per-landmark epipolar band parameters for stage-3 tracking.

Replaces the epipolar-curve stage of ``CFundamentalMatcher::trackEpipolar``
(CFundamentalMatcher.cpp:802-977): per landmark, the fundamental matrix from
the relative pose since its last observation, the epipolar line of that
observation, and a search reach scaled by principal-point weight and motion.

The geometry becomes five per-landmark integers consumed by the dense
window scorer (ops.track_kernel): a fixed-point line normal + offset and two
axis reaches. Candidates are ALL window pixels within ``BAND_HALF_WIDTH_PX``
of the line and within the reach. The fixed-point quantization (x256, round
half to even) makes the plain scorer and the CUDA kernel compare identical
integers. Every product stays in float32.

Key property: the epipolar line through the landmark's LAST observation
passes through its true current projection regardless of the error in the
landmark's 3D estimate — depth error slides the prediction *along* the line.
"""

from __future__ import annotations

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.mapping.landmarks import LandmarkTable
from svi_mapper_tpu_torch.ops.track_kernel import (  # noqa: F401
    BAND_HALF_WIDTH_Q,
    BAND_SCALE,
)

# half-width of the accepted band around the epipolar line, in pixels
BAND_HALF_WIDTH_PX = 2.5
assert BAND_HALF_WIDTH_Q == int(round(BAND_HALF_WIDTH_PX * BAND_SCALE))
# epipolar line base half-length in pixels (ref CFundamentalMatcher.h:92)
EPIPOLAR_BASE_LENGTH_PX = 15.0
# per-unit-motion-scaling line length gain (ref CFundamentalMatcher.cpp:779)
EPIPOLAR_MOTION_GAIN_PX = 10.0

_C0_CLIP = 1 << 20   # keeps |c0q| + |nxq*dx| + |nyq*dy| well inside int32


def motion_scaling(T_delta: torch.Tensor, cap: float = 5.0) -> torch.Tensor:
    """Search-window motion scaling from a frame-to-frame pose delta:
    ``min(1 + 10*|rot| + 0.5*|trans|, cap)`` (ref CTrackerGT.cpp:157)."""
    w = se3.log_so3(T_delta[:3, :3])
    t = T_delta[:3, 3]
    raw = 1.0 + 10.0 * torch.linalg.norm(w) + 0.5 * torch.linalg.norm(t)
    return torch.clamp(raw, max=cap)


def epipolar_band_params(
    table: LandmarkTable,
    T_wc_prior: torch.Tensor,    # [4,4] predicted world->LEFT-camera
    cam_left,                    # PinholeCamera
    uv_pred: torch.Tensor,       # [L, 2] predicted reprojections (float)
    ms: torch.Tensor | float = 1.0,  # motion scaling
    *,
    reach_x: int,
    reach_y: int,
    base_length_px: float = EPIPOLAR_BASE_LENGTH_PX,
):
    """Fixed-point oriented-band parameters per landmark.

    Returns one ``[5, L]`` int32 tensor, the rows ``(nxq, nyq, c0q, ru,
    rv)`` (the layout kernel K1 reads; it unpacks like a tuple):

    * ``(nxq, nyq)`` — unit line normal x ``BAND_SCALE``;
    * ``c0q`` — signed distance (x ``BAND_SCALE``) of the *rounded*
      prediction pixel from the line, so a window offset ``(dx, dy)`` from
      that pixel lies on the band iff
      ``|c0q + nxq*dx + nyq*dy| <= BAND_HALF_WIDTH_Q``;
    * ``(ru, rv)`` — per-axis search reach in pixels, clipped to the window.

    Landmarks whose relative translation since the last observation is
    (near) zero, or whose measurement ring is empty, fall back to a
    horizontal band through the prediction.
    """
    L = table.capacity
    M = table.max_measurements
    dt = uv_pred.dtype
    dev = uv_pred.device

    # --- relative pose last-observation -> prior, per landmark -----------
    idx = ((table.meas_next - 1) % M).to(torch.int64)
    T_last = table.meas_T_wc[torch.arange(L, device=dev), idx]   # [L,4,4]
    R_last = T_last[:, :3, :3]
    t_last = T_last[:, :3, 3]
    Rp = T_wc_prior[:3, :3].to(dt)
    tp = T_wc_prior[:3, 3].to(dt)
    # T_rel = T_prior @ inv(T_last): maps last-obs camera coords to current
    R_rel = torch.einsum("ij,lkj->lik", Rp, R_last)              # Rp R_l^T
    t_rel = tp[None, :] - torch.einsum("lij,lj->li", R_rel, t_last)

    # --- F = K^-T [t]x R K^-1 with the analytic pinhole K inverse ---------
    # (float32 quotients taken on the host: one small copy to the device)
    fx, fy, cx, cy = (np.float32(v) for v in
                      (cam_left.fx, cam_left.fy, cam_left.cx, cam_left.cy))
    one = np.float32(1.0)
    K_inv = torch.from_numpy(np.array(
        [[one / fx, 0.0, -cx / fx],
         [0.0, one / fy, -cy / fy],
         [0.0, 0.0, 1.0]], dtype=np.float32)).to(device=dev, dtype=dt)
    hat_t = se3.hat(t_rel)                               # [L,3,3]
    E = torch.einsum("lij,ljk->lik", hat_t, R_rel)
    F = torch.einsum("ji,ljk,km->lim", K_inv, E, K_inv)  # K^-T E K^-1

    # --- line through the LAST observation pixel -------------------------
    uv_last = table.uv_left_last                         # [L,2]
    uv1 = torch.cat([uv_last, torch.ones((L, 1), dtype=dt, device=dev)], -1)
    line = torch.einsum("lij,lj->li", F, uv1)            # [L,3] (a,b,c)
    a, b, c = line[:, 0], line[:, 1], line[:, 2]
    norm = torch.sqrt(a * a + b * b)

    ring_empty = table.meas_count == 0
    degenerate = (torch.sum(t_rel * t_rel, -1) < 1e-10) | (norm < 1e-12) | ring_empty
    safe = torch.clamp(norm, min=1e-12)
    zeros = torch.zeros_like(a)
    nx = torch.where(degenerate, zeros, a / safe)
    ny = torch.where(degenerate, torch.ones_like(a), b / safe)

    # signed distance of the rounded prediction pixel from the line
    uvs = torch.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    u_r = torch.round(uvs[:, 0])
    v_r = torch.round(uvs[:, 1])
    c0 = torch.where(degenerate, zeros, (a * u_r + b * v_r + c) / safe)

    nxq = torch.round(nx * BAND_SCALE).to(torch.int32)
    nyq = torch.round(ny * BAND_SCALE).to(torch.int32)
    c0q = torch.clamp(torch.round(c0 * BAND_SCALE), -_C0_CLIP, _C0_CLIP).to(torch.int32)

    # --- principal-weight + motion scaled reach (ref .cpp:858-859) -------
    pw = cam_left.principal_weight(uvs)                  # [L,2]
    ms_t = torch.as_tensor(ms, dtype=dt, device=dev)
    half = base_length_px + pw * (EPIPOLAR_MOTION_GAIN_PX * ms_t)
    ru = torch.clamp(torch.round(half[:, 0]), 1, reach_x).to(torch.int32)
    rv = torch.clamp(torch.round(half[:, 1]), 1, reach_y).to(torch.int32)
    return torch.stack([nxq, nyq, c0q, ru, rv])


def fixed_band_params(L: int, reach_x: int, reach_y: int,
                      device: torch.device | str = "cpu"):
    """The pre-epipolar fixed horizontal band (|dy| <= 2, |dx| <= reach_x)
    expressed as band parameters — used when epipolar steering is disabled
    and as the degenerate-translation fallback geometry. ``[5, L]`` int32,
    as :func:`epipolar_band_params`."""
    # built on the device: no host tensor to copy over
    band = torch.zeros((5, L), dtype=torch.int32, device=device)
    band[1] = BAND_SCALE
    band[3] = reach_x
    band[4] = reach_y
    return band
