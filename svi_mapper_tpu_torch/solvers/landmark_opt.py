"""Per-landmark position refinement: batched robust Gauss-Newton.

Replaces ``CLandmark::optimize`` -> ``_getOptimizedLandmarkSTEREOUV``
(CLandmark.cpp:447-581): for each landmark, re-project its stored world
position through every recorded stereo measurement's camera pose, form the
4D reprojection residual, and iterate GN with the 10 px^2 robust kernel
until delta < 1e-5. The whole table refines in one batched computation.

Formulation: structure of arrays. Every working tensor is ``[M, L]``
(measurements x landmarks), the 3x3 normal system is held as six ``[L]``
components and solved in closed form (symmetric Cramer). A landmark freezes
once its own step falls under ``convergence``, which reproduces a
per-landmark loop exactly; the Python loop ends when every landmark has
frozen (one host read per iteration) or at ``max_iterations``.

Acceptance gates are the reference's (CLandmark.h:90-98): >= 5 measurements,
inlier ratio > 0.5 at 10 px^2, average error < 9 px^2 -> ``is_optimal``.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.mapping.landmarks import LandmarkTable, measurement_mask


def _solve3x3_sym(h00, h01, h02, h11, h12, h22, b0, b1, b2):
    """Closed-form solve of a symmetric 3x3 system, all inputs [L]."""
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    det = h00 * c00 + h01 * c01 + h02 * c02
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det,
                          torch.zeros_like(det))
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return x0, x1, x2


def _reproject(R, t, p, fx, fy, cx, cy, bq):
    """[M,L] stereo reprojection of [3][L] points through [3][3][M,L] poses.

    Returns (x, y, z, iz, u_l, v_l, u_r) all [M, L].
    """
    x = R[0][0] * p[0] + R[0][1] * p[1] + R[0][2] * p[2] + t[0]
    y = R[1][0] * p[0] + R[1][1] * p[1] + R[1][2] * p[2] + t[1]
    z = R[2][0] * p[0] + R[2][1] * p[1] + R[2][2] * p[2] + t[2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    return x, y, z, iz, u_l, v_l, u_r


def _refine_soa(table, fx, fy, cx, cy, bq,
                kernel_px2, max_iterations, convergence, damping):
    """Refinement core. Returns per-landmark
    (p_opt [L,3], inlier_ratio, avg_err, ok_geom)."""
    dtype = table.pos_w.dtype
    dev = table.device

    # --- lay the data out landmark-axis-last: everything [M, L] ---------
    mask = measurement_mask(table).to(dtype).T                    # [M, L]
    uv = table.meas_uv.permute(1, 2, 0).contiguous()              # [M, 4, L]
    obs_ul, obs_vl, obs_ur, obs_vr = (uv[:, k] for k in range(4))
    Tm = table.meas_T_wc.permute(1, 2, 3, 0).contiguous()         # [M, 4, 4, L]
    R = [[Tm[:, i, j] for j in range(3)] for i in range(3)]       # [3][3] of [M,L]
    t = [Tm[:, i, 3] for i in range(3)]                           # [3] of [M,L]
    p = [table.pos_w[:, i] for i in range(3)]                     # [3] of [L]
    L = table.pos_w.shape[0]

    def residuals(p):
        x, y, z, iz, u_l, v_l, u_r = _reproject(R, t, p, fx, fy, cx, cy, bq)
        r_ul = u_l - obs_ul
        r_vl = v_l - obs_vl
        r_ur = u_r - obs_ur
        r_vr = v_l - obs_vr
        err2 = r_ul * r_ul + r_vl * r_vl + r_ur * r_ur + r_vr * r_vr
        return x, y, z, iz, r_ul, r_vl, r_ur, r_vr, err2

    def step(p, delta):
        x, y, z, iz, r_ul, r_vl, r_ur, r_vr, err2 = residuals(p)
        w = torch.where(err2 > kernel_px2,
                        kernel_px2 / torch.clamp(err2, min=1e-12),
                        torch.ones_like(err2))
        w = w * mask * (z > 0.05)

        iz2 = iz * iz
        a_l = fx * iz          # d u_l / d x_cam
        g_l = -fx * x * iz2    # d u_l / d z_cam
        a_v = fy * iz
        g_v = -fy * y * iz2
        g_r = -(fx * x + bq) * iz2   # d u_r / d z_cam (d/dx same as left)
        # J rows in world coords: J_row[j] = a * R[0 or 1][j] + g * R[2][j]
        Jul = [a_l * R[0][j] + g_l * R[2][j] for j in range(3)]
        Jvl = [a_v * R[1][j] + g_v * R[2][j] for j in range(3)]
        Jur = [a_l * R[0][j] + g_r * R[2][j] for j in range(3)]

        def hsum(i, j):
            # v-row appears twice (v_l and v_r share the prediction)
            return torch.sum(w * (Jul[i] * Jul[j] + 2.0 * Jvl[i] * Jvl[j]
                                  + Jur[i] * Jur[j]), dim=0)

        h00, h01, h02 = hsum(0, 0), hsum(0, 1), hsum(0, 2)
        h11, h12, h22 = hsum(1, 1), hsum(1, 2), hsum(2, 2)
        b = [torch.sum(w * (Jul[i] * r_ul + Jvl[i] * (r_vl + r_vr)
                            + Jur[i] * r_ur), dim=0) for i in range(3)]
        d0, d1, d2 = _solve3x3_sym(
            h00 + damping, h01, h02, h11 + damping, h12, h22 + damping,
            b[0], b[1], b[2])
        # per-landmark convergence freeze
        live = delta > convergence                               # [L]
        dp = [torch.where(live, -d, torch.zeros_like(d)) for d in (d0, d1, d2)]
        new_delta = torch.maximum(torch.maximum(torch.abs(dp[0]), torch.abs(dp[1])),
                                  torch.abs(dp[2]))
        p_new = [p[i] + dp[i] for i in range(3)]
        return p_new, torch.where(live, new_delta, delta)

    delta = torch.full((L,), float("inf"), dtype=dtype, device=dev)
    it = 0
    while it < max_iterations and bool(torch.any(delta > convergence)):
        p, delta = step(p, delta)
        it += 1

    # --- acceptance gates at the solution --------------------------------
    _, _, z, _, _, _, _, _, err2 = residuals(p)
    usable = mask * (z > 0.05)                                  # [M, L]
    n_raw = torch.sum(usable, dim=0)
    n_usable = torch.clamp(n_raw, min=1.0)                      # [L]
    inlier_ratio = torch.sum(usable * (err2 < kernel_px2), dim=0) / n_usable
    avg_err = torch.sum(torch.where(usable > 0, err2, torch.zeros_like(err2)),
                        dim=0) / n_usable
    p_stack = torch.stack(p, dim=-1)                            # [L, 3]
    ok_geom = torch.all(torch.isfinite(p_stack), dim=-1) & (n_raw > 0)
    return p_stack, inlier_ratio, avg_err, ok_geom


def optimize_landmarks(
    table: LandmarkTable,
    cam: StereoCamera,
    *,
    min_measurements: int = 5,
    kernel_px2: float = 10.0,
    max_error_px2: float = 9.0,
    min_inlier_ratio: float = 0.5,
    max_iterations: int = 100,
    convergence: float = 1e-5,
    damping: float = 1e-6,
    idwa_fallback: bool = False,
) -> LandmarkTable:
    """Refine every eligible landmark in the table in one batched
    computation (replaces the per-frame ``optimizeActiveLandmarks`` loop,
    CFundamentalMatcher.cpp:265 -> CLandmark.cpp:447-581). Positions update
    only for landmarks passing the gates; success/failure counters and
    ``is_optimal`` update exactly as the reference's lifecycle does.
    """
    if idwa_fallback:
        raise NotImplementedError(
            "the IDWA landmark-refinement fallback is not ported yet")
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.p03

    p_stack, inlier_ratio, avg_err, ok_geom = _refine_soa(
        table, fx, fy, cx, cy, bq,
        kernel_px2, max_iterations, convergence, damping)

    eligible = table.active & (table.meas_count >= min_measurements)
    success = (
        eligible & ok_geom
        & (inlier_ratio > min_inlier_ratio)
        & (avg_err < max_error_px2)
    )
    return table.replace(
        pos_w=torch.where(success[:, None], p_stack, table.pos_w),
        is_optimal=torch.where(eligible, success, table.is_optimal),
        opt_success=table.opt_success + success.to(torch.int32),
        opt_failed=table.opt_failed + (eligible & ~success).to(torch.int32),
    )
