"""Robust stereo-reprojection pose solver ("stereo posit").

Replaces ``CSolverStereoPosit`` (CSolverStereoPosit.cpp:8-170):
Gauss-Newton over all stereo landmark matches of one frame; the residual is
the 4D stereo reprojection error (u_L, v_L, u_R, v_R), the Jacobian chains
the homogeneous-division derivative through the projection and the
left-multiplicative se(3) update; the 6x6 normal system is solved each
iteration and the update applied as ``exp(xi) @ T`` with cheap rotation
re-orthogonalization.

The exception-based failure protocol of the reference becomes a returned
``PositResult.ok`` flag from the same gates: >= 25 points, >= 15 inliers at
the 10 px^2 kernel, average error <= 9 px^2, and the prior-consistency RISK
bound ``||t_opt - t_prior - t_imu||^2 <= 2.0``.

The iteration is a Python loop that runs ``unroll`` GN steps per
convergence check, exactly like the JAX package's ``while_loop`` body, so
the iteration count and the result match; each check reads one scalar from
the device.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.geometry import linalg, se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera


@dataclasses.dataclass
class PositResult:
    T_wc: torch.Tensor         # [4,4] optimized world->LEFT-camera transform
    ok: torch.Tensor           # scalar bool — all gates passed
    inliers: torch.Tensor      # scalar int32
    avg_error_px2: torch.Tensor  # scalar — average squared reprojection error
    iterations: torch.Tensor   # scalar int32
    inlier_mask: torch.Tensor  # [N] bool


def _stereo_residual_jacobian(T_wc, p_w, uv4, fx, fy, cx, cy, bq):
    """Residual [N,4] and Jacobian [N,4,6] for all points.

    bq = P_right[0,3] (= -fx * baseline). Points are world-frame; the state
    is T_wc (world -> left camera) updated left-multiplicatively.
    """
    p_c = se3.transform(T_wc, p_w)                     # [N,3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    r = torch.stack([u_l, v_l, u_r, v_l], dim=-1) - uv4  # [N,4] (v_R==v_L)

    zr = torch.zeros_like(x)
    J_ul = torch.stack([fx * iz, zr, -fx * x * iz2], dim=-1)
    J_vl = torch.stack([zr, fy * iz, -fy * y * iz2], dim=-1)
    J_ur = torch.stack([fx * iz, zr, -(fx * x + bq) * iz2], dim=-1)
    J_uv = torch.stack([J_ul, J_vl, J_ur, J_vl], dim=-2)  # [N,4,3]

    # d p_c / d xi for left-multiplied exp(xi): [I3 | -hat(p_c)]
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(
        p_c.shape[0], 3, 3)
    J_p = torch.cat([eye, -se3.hat(p_c)], dim=-1)      # [N,3,6]
    J = J_uv @ J_p                                     # [N,4,6]
    return r, J, z


def solve_stereo_posit(
    T_init: torch.Tensor,          # [4,4] prior world->camera
    p_w: torch.Tensor,             # [N,3] landmark world positions
    uv4: torch.Tensor,             # [N,4] measured (uL, vL, uR, vR)
    valid: torch.Tensor,           # [N] bool
    cam: StereoCamera,
    *,
    T_prior: torch.Tensor | None = None,   # pose prior for the RISK check
    t_imu: torch.Tensor | None = None,     # IMU-predicted translation delta
    kernel_px2: float = 10.0,
    min_points: int = 25,
    min_inliers: int = 15,
    max_error_px2: float = 9.0,
    max_risk_m2: float = 2.0,
    max_iterations: int = 100,
    convergence: float = 1e-5,
    damping: float = 1e-6,
    unroll: int = 2,
) -> PositResult:
    """Solve the frame pose from stereo matches; gates encode the reference's
    failure protocol as a returned flag instead of an exception."""
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.p03
    dt, dev = T_init.dtype, T_init.device
    if T_prior is None:
        T_prior = T_init
    if t_imu is None:
        t_imu = torch.zeros(3, dtype=dt, device=dev)
    n_valid = torch.sum(valid.to(torch.int32))
    w_valid = valid.to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def gn_step(T):
        r, J, z = _stereo_residual_jacobian(T, p_w, uv4, fx, fy, cx, cy, bq)
        err2 = torch.sum(r * r, dim=-1)
        # robust kernel: unit weight inside, kernel/err2 outside
        # (ref CSolverStereoPosit.cpp:92-99, 10 px^2)
        w = torch.where(err2 > kernel_px2,
                        kernel_px2 / torch.clamp(err2, min=1e-12),
                        torch.ones_like(err2))
        # depth sanity: only points in front of the camera contribute
        w = w * w_valid * (z > 0.05)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = torch.einsum("nri,nr->i", Jw, r)
        H = H + damping * eye6
        xi = -linalg.solve6x6_spd(H, b)
        return se3.apply_left_update(xi, T), torch.max(torch.abs(xi))

    T_opt = T_init
    iters = 0
    delta = float("inf")
    # NaN deltas end the loop, as ``delta > convergence`` is False for NaN
    while iters < max_iterations and delta > convergence:
        for _ in range(max(1, unroll)):
            T_opt, d = gn_step(T_opt)
            iters += 1
        delta = float(d)          # one host read per convergence check

    # final gates (ref CSolverStereoPosit.cpp:117-153)
    r, _, z = _stereo_residual_jacobian(T_opt, p_w, uv4, fx, fy, cx, cy, bq)
    err2 = torch.sum(r * r, dim=-1)
    usable = valid & (z > 0.05)
    inlier = usable & (err2 < kernel_px2)
    n_inliers = torch.sum(inlier.to(torch.int32))
    # robust average: error over inliers only
    avg_err = torch.sum(torch.where(inlier, err2, torch.zeros_like(err2))) \
        / torch.clamp(n_inliers, min=1)

    # prior-consistency RISK check (ref .h:89-98, .cpp:144-150)
    t_opt_w = se3.inv_T(T_opt)[:3, 3]
    t_prior_w = se3.inv_T(T_prior)[:3, 3]
    risk = torch.sum((t_opt_w - t_prior_w - t_imu) ** 2)

    ok = (
        (n_valid >= min_points)
        & (n_inliers >= min_inliers)
        & (avg_err <= max_error_px2)
        & (risk <= max_risk_m2)
        & torch.all(torch.isfinite(T_opt))
    )
    return PositResult(
        T_wc=torch.where(ok, T_opt, T_init),
        ok=ok,
        inliers=n_inliers,
        avg_error_px2=avg_err,
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
        inlier_mask=inlier,
    )
