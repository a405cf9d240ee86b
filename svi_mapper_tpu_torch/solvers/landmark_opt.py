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

On a landmark-sharded table (``shards``) each rank refines its own rows and
the loop's end flag is OR-ed over the ranks before it is read, so every
shard iterates as often as the whole table does on one device (a frozen
row stays frozen, so each row gets its one-device bits).
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
                kernel_px2, max_iterations, convergence, damping, shards=None):
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
    def any_live() -> bool:
        live = torch.any(delta > convergence)
        return bool(live if shards is None else shards.any(live))

    while it < max_iterations and any_live():
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


def _idwa_positions(table, fx, fy, cx, cy, bq):
    """[L,3] inverse-depth-weighted average of the measurement
    back-projections — the reference's ``_getOptimizedLandmarkIDWA``
    (CLandmark.cpp:583-646). The reference's 3D-point GN alternate
    ``_getOptimizedLandmarkLEFT3D`` (:347-445) has the (robust) MEAN of the
    same back-projections as its stationary point — the unweighted special
    case of this average — so one implementation covers both dormant
    alternates. Used as the degenerate-geometry fallback when the STEREOUV
    GN fails its gates."""
    uv = table.meas_uv                                   # [L,M,4]
    disp = uv[..., 0] - uv[..., 2]
    z = torch.where(disp > 0.01, -bq / torch.clamp(disp, min=0.01),
                    torch.full_like(disp, float("inf")))
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    p_c = torch.stack([x, y, z], -1)                     # [L,M,3]
    R = table.meas_T_wc[..., :3, :3]                     # [L,M,3,3]
    t = table.meas_T_wc[..., :3, 3]
    mask = measurement_mask(table)                       # [L,M]
    ok = mask & torch.isfinite(z) & (z > 0.05)
    w = torch.where(ok, 1.0 / torch.clamp(z, min=0.05), torch.zeros_like(z))
    d = torch.where(ok[..., None], p_c, torch.zeros_like(p_c)) - t
    # R^T d, products and sums in the contraction's order
    p_w = torch.stack([R[..., 0, i] * d[..., 0] + R[..., 1, i] * d[..., 1]
                       + R[..., 2, i] * d[..., 2] for i in range(3)], dim=-1)
    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-9)
    return torch.sum(w[..., None] * p_w, dim=1) / wsum[:, None]


def _evaluate_at(table, p, fx, fy, cx, cy, bq, kernel_px2):
    """Acceptance-gate statistics of candidate positions ``p`` [L,3]:
    (inlier_ratio [L], avg_err [L], ok_geom [L])."""
    R = table.meas_T_wc[..., :3, :3]                     # [L,M,3,3]
    pl = p[:, None, :]
    p_c = torch.stack([R[..., i, 0] * pl[..., 0] + R[..., i, 1] * pl[..., 1]
                       + R[..., i, 2] * pl[..., 2] for i in range(3)], dim=-1) \
        + table.meas_T_wc[..., :3, 3]                    # [L,M,3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    uv = table.meas_uv
    err2 = ((u_l - uv[..., 0]) ** 2 + (v_l - uv[..., 1]) ** 2
            + (u_r - uv[..., 2]) ** 2 + (v_l - uv[..., 3]) ** 2)
    usable = measurement_mask(table).to(p.dtype) * (z > 0.05)
    n_raw = torch.sum(usable, dim=1)
    n = torch.clamp(n_raw, min=1.0)
    inlier_ratio = torch.sum(usable * (err2 < kernel_px2), dim=1) / n
    avg_err = torch.sum(torch.where(usable > 0, err2, torch.zeros_like(err2)), dim=1) / n
    ok_geom = torch.all(torch.isfinite(p), dim=-1) & (n_raw > 0)
    return inlier_ratio, avg_err, ok_geom


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
    shards=None,
) -> LandmarkTable:
    """Refine every eligible landmark in the table in one batched
    computation (replaces the per-frame ``optimizeActiveLandmarks`` loop,
    CFundamentalMatcher.cpp:265 -> CLandmark.cpp:447-581). Positions update
    only for landmarks passing the gates; success/failure counters and
    ``is_optimal`` update exactly as the reference's lifecycle does.

    ``idwa_fallback`` (opt-in, ``TrackingParams.landmark_idwa_fallback``):
    a landmark whose GN fails its gates is tried at the inverse-depth-
    weighted average of its measurement back-projections, and passes there
    under the same gates.
    """
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.p03

    p_stack, inlier_ratio, avg_err, ok_geom = _refine_soa(
        table, fx, fy, cx, cy, bq,
        kernel_px2, max_iterations, convergence, damping, shards)

    eligible = table.active & (table.meas_count >= min_measurements)
    success = (
        eligible & ok_geom
        & (inlier_ratio > min_inlier_ratio)
        & (avg_err < max_error_px2)
    )
    if idwa_fallback:
        # degenerate-geometry fallback (the reference's dormant alternates
        # _getOptimizedLandmarkLEFT3D / _getOptimizedLandmarkIDWA,
        # CLandmark.cpp:347-445,583-646): it ignores the (possibly
        # ill-conditioned) GN landscape and passes exactly when the raw
        # measurements agree
        p_idwa = _idwa_positions(table, fx, fy, cx, cy, bq)
        ir2, ae2, ok2 = _evaluate_at(table, p_idwa, fx, fy, cx, cy, bq, kernel_px2)
        idwa_ok = (eligible & ~success & ok2
                   & (ir2 > min_inlier_ratio) & (ae2 < max_error_px2))
        p_stack = torch.where(idwa_ok[:, None], p_idwa, p_stack)
        success = success | idwa_ok
    return table.replace(
        pos_w=torch.where(success[:, None], p_stack, table.pos_w),
        is_optimal=torch.where(eligible, success, table.is_optimal),
        opt_success=table.opt_success + success.to(torch.int32),
        opt_failed=table.opt_failed + (eligible & ~success).to(torch.int32),
    )
