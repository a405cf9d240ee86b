"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Replacement for the full-graph stage of ``Cg2oOptimizer``
(Cg2oOptimizer.cpp:232-522: BlockSolverX + CHOLMOD + Levenberg over pose and
landmark vertices with Cauchy-robust stereo measurement edges, iterated
until <1 % chi^2 improvement, :954-980). The Schur trick keeps everything
block-dense and batched:

  * residuals/Jacobians for ALL (keyframe, landmark) observations at once
    from a dense ``[K, L, 4]`` observation tensor + mask;
  * the reduced camera system ``S = H_pp - W H_ll^-1 W^T`` is a small dense
    ``[6K, 6K]`` matrix solved by Cholesky;
  * Levenberg damping with accept/reject on chi^2, a fixed iteration cap and
    the reference's <1 % relative-improvement stop.

Gauge freedom is fixed by masking updates of designated poses
(``fix_mask``), the analog of g2o's setFixed (Cg2oOptimizer.cpp:342-360).

Two routes to the Schur system: the fused assembly of ``ops.ba_kernel``
(hand-written CUDA kernels K4 / K5 on the card, their plain versions on the
CPU) and the materialised-Jacobian route, which is the route for windows the
kernels do not take and the default on the CPU.

The LM loop is a Python loop. One iteration reads two flags (accept, done)
from the device in ONE transfer; the damping ``lam`` lives on the host as a
float32, so the kernels get it by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.geometry.linalg import cholesky_solve_or_nan
from svi_mapper_tpu_torch.geometry.linalg import inv3x3 as _inv3x3
from svi_mapper_tpu_torch.ops import ba_kernel
from svi_mapper_tpu_torch.solvers.pose_graph import adjoint as _adjoint
from svi_mapper_tpu_torch.utils.device import require_fp32_matmul, resolve_device

# largest keyframe window the single-pass fused kernel
# (ops.ba_kernel.schur_assemble) takes; windows past it use the K-tiled
# kernel (schur_assemble_tiled, 32 keyframes per tile) up to
# SCHUR_KERNEL_TILED_MAX_K; anything else takes the materialised route.
SCHUR_KERNEL_MAX_K = 32
SCHUR_KERNEL_TILED_MAX_K = 128


def schur_kernel_auto(K: int, dtype=torch.float32, device=None) -> bool:
    """The ``use_schur_kernel=None`` gate of :func:`bundle_adjust`: float32
    problems on a CUDA device whose window a kernel takes. By shape only."""
    device = torch.device("cuda" if device is None else device)
    return (device.type == "cuda" and dtype == torch.float32
            and (K <= SCHUR_KERNEL_MAX_K
                 or (K % 32 == 0 and K <= SCHUR_KERNEL_TILED_MAX_K)))


@dataclasses.dataclass(frozen=True)
class BAResult:
    T_wc: torch.Tensor        # [K,4,4] optimized poses
    points_w: torch.Tensor    # [L,3] optimized landmarks
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: torch.Tensor


def _residuals(T_wc, X, obs_uv, fx, fy, cx, cy, bq):
    """r [K,L,4], p_cam [K,L,3] for all observation pairs."""
    p_c = torch.einsum("kij,lj->kli", T_wc[:, :3, :3], X) + T_wc[:, None, :3, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    pred = torch.stack([u_l, v_l, u_r, v_l], dim=-1)
    return pred - obs_uv, p_c


def _jacobians(p_c, T_wc, fx, fy, bq):
    """J_pose [K,L,4,6] (left-mult se3 of T_k), J_point [K,L,4,3] (world X)."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zr = torch.zeros_like(x)
    J_ul = torch.stack([fx * iz, zr, -fx * x * iz2], dim=-1)
    J_vl = torch.stack([zr, fy * iz, -fy * y * iz2], dim=-1)
    J_ur = torch.stack([fx * iz, zr, -(fx * x + bq) * iz2], dim=-1)
    J_uv = torch.stack([J_ul, J_vl, J_ur, J_vl], dim=-2)          # [K,L,4,3]
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(
        p_c.shape[:-1] + (3, 3))
    J_pc = torch.cat([eye, -se3.hat(p_c)], dim=-1)                # [K,L,3,6]
    J_pose = J_uv @ J_pc
    # d p_c / d X_world = R_k
    J_point = torch.einsum("klri,kij->klrj", J_uv, T_wc[:, :3, :3])
    return J_pose, J_point


def _chi2(r, w_mask):
    return torch.sum(w_mask * torch.sum(r * r, dim=-1))


def _intrinsics(cam: StereoCamera):
    return cam.left.fx, cam.left.fy, cam.left.cx, cam.left.cy, cam.right.p03


def _on(t, dev, dtype=None):
    return None if t is None else torch.as_tensor(t, device=dev, dtype=dtype)


def bundle_adjust(
    T_wc: torch.Tensor,          # [K,4,4]
    points_w: torch.Tensor,      # [L,3]
    obs_uv: torch.Tensor,        # [K,L,4]
    obs_mask: torch.Tensor,      # [K,L] bool
    cam: StereoCamera,
    fix_mask: torch.Tensor,      # [K] bool — poses held fixed (gauge)
    *,
    kernel_px2: float = 10.0,
    max_iterations: int = 10,
    lm_lambda0: float = 1e-4,
    point_damping: float = 1e-6,
    min_rel_improvement: float = 0.01,   # ref <1% chi2 stop (Cg2o:966-977)
    odo_M: torch.Tensor | None = None,   # [K,4,4] pose-pose chain measurements
                                         # (entry k: T_{k+1} <- k; the
                                         # reference's EdgeSE3 chain,
                                         # Cg2o:1258-1266)
    odo_w: torch.Tensor | None = None,   # [K] edge weights (0 disables; last
                                         # entry unused)
    grav_d: torch.Tensor | None = None,  # [K,3] measured camera-frame down
                                         # directions — per-keyframe gravity
                                         # unary (ref
                                         # EdgeSE3LinearAcceleration,
                                         # Cg2oOptimizer.cpp:982-997)
    grav_w: torch.Tensor | None = None,  # [K] gravity weights (0 disables)
    obs_w: torch.Tensor | None = None,   # [K,L] per-observation information
                                         # scale (depth-tiered weighting, ref
                                         # dInformationFactor = 1/z,
                                         # Cg2oOptimizer.cpp:1403-1466);
                                         # multiplies into the mask/robust
                                         # weight on both routes
    use_schur_kernel: bool | None = None,  # fused Schur assembly
                                         # (ops.ba_kernel); None = by shape
                                         # on a CUDA device, off on the CPU
    device=None,
) -> BAResult:
    """Windowed bundle adjustment. ``device=None`` means CUDA (raises
    without one); inputs are moved there. With ``use_schur_kernel=None`` on a
    CUDA device: K <= 32 goes through kernel K4, K % 32 == 0 and K <= 128
    through K5, anything else through the materialised route. A kernel that
    fails to build or launch raises; nothing gives way to another route."""
    dev = resolve_device(device)
    T_wc = _on(T_wc, dev)
    points_w = _on(points_w, dev)
    dtype = points_w.dtype
    obs_uv = _on(obs_uv, dev, dtype)
    obs_mask = _on(obs_mask, dev)
    fix_mask = _on(fix_mask, dev)
    require_fp32_matmul(points_w)
    fx, fy, cx, cy, bq = _intrinsics(cam)
    K = T_wc.shape[0]
    L = points_w.shape[0]
    maskf = obs_mask.to(dtype)
    if obs_w is not None:
        maskf = maskf * _on(obs_w, dev, dtype)

    def robust_w(r):
        err2 = torch.sum(r * r, dim=-1)
        w = torch.where(err2 > kernel_px2,
                        kernel_px2 / torch.clamp(err2, min=1e-12),
                        torch.ones_like(err2))
        return w * maskf

    # pose-pose odometry chain (ref EdgeSE3 full-graph edges,
    # Cg2oOptimizer.cpp:1258-1266): keeps weakly-observed keyframes anchored
    # to the trajectory while reprojection terms refine
    use_odo = odo_M is not None
    if use_odo:
        odo_Minv = se3.inv_T(_on(odo_M, dev, dtype)[: K - 1])
        wo = _on(odo_w, dev, dtype)[: K - 1]

    def odo_residuals(T):
        Dk = T[1:] @ se3.inv_T(T[:-1])
        return Dk, se3.log_se3(Dk @ odo_Minv)                     # [K-1,6]

    def odo_chi2(T):
        if not use_odo:
            return torch.zeros((), dtype=dtype, device=dev)
        _, r_o = odo_residuals(T)
        return torch.sum(wo * torch.sum(r_o * r_o, dim=-1))

    # gravity-direction unary (ref error = R_n2w a_hat - (0,0,-1),
    # edge_se3_linear_acceleration.cpp:106-116; the world down here is
    # (0,-1,0)): residual r_g = R_wc g_down - d_measured,
    # J = [0 | -hat(R g_down)] under the left-multiplicative update
    use_grav = grav_d is not None
    if use_grav:
        grav_d = _on(grav_d, dev, dtype)
        grav_w = _on(grav_w, dev, dtype)

    def grav_residuals(T):
        Rg = -T[:, :3, 1]                     # R_wc @ (0,-1,0)
        return Rg, Rg - grav_d                # [K,3], [K,3]

    def grav_chi2(T):
        if not use_grav:
            return torch.zeros((), dtype=dtype, device=dev)
        _, r_g = grav_residuals(T)
        return torch.sum(grav_w * torch.sum(r_g * r_g, dim=-1))

    def total_chi2(T, X):
        r, _ = _residuals(T, X, obs_uv, fx, fy, cx, cy, bq)
        return _chi2(r, robust_w(r)) + odo_chi2(T) + grav_chi2(T)

    chi2_init = total_chi2(T_wc, points_w)

    if use_schur_kernel is None:
        use_kernel = schur_kernel_auto(K, dtype, dev)
    else:
        use_kernel = bool(use_schur_kernel)
    assemble = (ba_kernel.schur_assemble if K <= SCHUR_KERNEL_MAX_K
                else ba_kernel.schur_assemble_tiled)

    kk = torch.arange(K, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    free = (~fix_mask).to(dtype)                                  # [K]

    def lm_step(T, X, lam):
        """One LM proposal: ``(T_new, X_new)`` at damping ``lam``."""
        if use_kernel:
            # fused assembly: residuals/weights/Jacobians never materialised;
            # returns the UNdamped S and the back-substitution operands
            S, rhs, H_ll_inv, b_l, Wpl = assemble(
                T, X, obs_uv, maskf, lam, fx=fx, fy=fy, cx=cx, cy=cy, bq=bq,
                kernel_px2=kernel_px2, point_damping=point_damping)
            S[kk, :, kk, :] += lam * eye6
        else:
            r, p_c = _residuals(T, X, obs_uv, fx, fy, cx, cy, bq)
            w = robust_w(r)                                          # [K,L]
            # in-front mask (behind-camera obs excluded)
            w = w * (p_c[..., 2] > 0.05).to(dtype)
            J_pose, J_point = _jacobians(p_c, T, fx, fy, bq)

            Jpw4 = J_pose * w[..., None, None]                       # [K,L,4,6]
            Jp = J_pose.reshape(K, L * 4, 6)
            Jpw = Jpw4.reshape(K, L * 4, 6)
            Jl = J_point.permute(1, 0, 2, 3).reshape(L, K * 4, 3)
            Jlw = (J_point * w[..., None, None]).permute(1, 0, 2, 3).reshape(L, K * 4, 3)
            rk = r.reshape(K, L * 4, 1)
            rl = r.permute(1, 0, 2).reshape(L, K * 4, 1)

            H_pp = Jpw.transpose(1, 2) @ Jp                          # [K,6,6]
            H_ll = Jlw.transpose(1, 2) @ Jl                          # [L,3,3]
            H_pl = Jpw4.transpose(-1, -2) @ J_point                  # [K,L,6,3]
            b_p = (Jpw.transpose(1, 2) @ rk)[..., 0]                 # [K,6]
            b_l = (Jlw.transpose(1, 2) @ rl)[..., 0]                 # [L,3]

            # Levenberg damping
            H_pp = H_pp + lam * eye6
            H_ll = H_ll + (lam + point_damping) * torch.eye(3, dtype=dtype, device=dev)
            H_ll_inv = _inv3x3(H_ll)                                 # [L,3,3]

            # Schur complement S = H_pp_diag - W Hll^-1 W^T as ONE
            # [K6, L3] x [L3, K6] product
            W_Hinv = H_pl @ H_ll_inv[None]                           # [K,L,6,3]
            A = W_Hinv.permute(0, 2, 1, 3).reshape(K * 6, L * 3)
            B = H_pl.permute(0, 2, 1, 3).reshape(K * 6, L * 3)
            S = (-(A @ B.T)).reshape(K, 6, K, 6)
            S[kk, :, kk, :] += H_pp
            rhs = b_p - (A @ b_l.reshape(L * 3)).reshape(K, 6)

        if use_odo:
            # J_{k+1} = I, J_k = -Adj(D_k) (left-multiplicative updates)
            Dk, r_o = odo_residuals(T)
            Adj = _adjoint(Dk)                                    # [K-1,6,6]
            AdjT = Adj.transpose(1, 2)
            ks = kk[: K - 1]
            wk = wo[:, None, None]
            S[ks + 1, :, ks + 1, :] += wk * eye6
            S[ks, :, ks, :] += wk * (AdjT @ Adj)
            S[ks, :, ks + 1, :] += -wk * AdjT
            S[ks + 1, :, ks, :] += -wk * Adj
            # ks and ks + 1 hold no index twice: the in-place adds are exact
            rhs[ks + 1] += wo[:, None] * r_o
            rhs[ks] += -wo[:, None] * torch.einsum("kji,kj->ki", Adj, r_o)

        if use_grav:
            Rg, r_g = grav_residuals(T)
            Ag = -se3.hat(Rg)                                 # [K,3,3] = J_phi
            S[kk, 3:, kk, 3:] += grav_w[:, None, None] * (Ag.transpose(1, 2) @ Ag)
            rhs[:, 3:] += grav_w[:, None] * torch.einsum("kji,kj->ki", Ag, r_g)

        # gauge fixing: zero out rows/cols of fixed poses, identity diagonal
        Sm = S * free[:, None, None, None] * free[None, None, :, None]
        Sm[kk, :, kk, :] += (1.0 - free)[:, None, None] * eye6
        rhs = rhs * free[:, None]

        dp = -cholesky_solve_or_nan(Sm.reshape(K * 6, K * 6), rhs.reshape(K * 6))
        dp = dp.reshape(K, 6) * free[:, None]
        # back-substitute landmark updates
        if use_kernel:
            Wdp = torch.einsum("bql,q->lb", Wpl, dp.reshape(K * 6))  # [L,3]
        else:
            Wdp = (B.T @ dp.reshape(K * 6)).reshape(L, 3)
        dx = -(H_ll_inv @ (b_l + Wdp)[..., None])[..., 0]
        return se3.apply_left_update(dp, T), X + dx

    T, X = T_wc, points_w
    lam = np.float32(lm_lambda0)
    chi2 = chi2_init
    iters = 0
    while iters < max_iterations:
        T_new, X_new = lm_step(T, X, float(lam))
        chi2_new = total_chi2(T_new, X_new)
        accept_t = chi2_new < chi2
        rel_gain = (chi2 - chi2_new) / torch.clamp(chi2, min=1e-12)
        done_t = accept_t & (rel_gain < min_rel_improvement)
        # the iteration's one host read
        accept, done = torch.stack([accept_t, done_t]).tolist()
        if accept:
            T, X, chi2 = T_new, X_new, chi2_new
        lam = lam * np.float32(0.3) if accept else lam * np.float32(8.0)
        iters += 1
        if done:
            break

    return BAResult(
        T_wc=T, points_w=X, chi2_initial=chi2_init, chi2_final=chi2,
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
    )


def reprojection_stats(
    T_wc: torch.Tensor,          # [K,4,4]
    points_w: torch.Tensor,      # [L,3]
    obs_uv: torch.Tensor,        # [K,L,4]
    obs_mask: torch.Tensor,      # [K,L] bool
    cam: StereoCamera,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-landmark post-BA health: (mean squared reprojection error [L],
    minimum observing-camera depth [L]) — the excision criteria of the
    reference's _applyOptimizationToLandmarks (Cg2oOptimizer.cpp:1486-1504)."""
    dev = resolve_device(device)
    T_wc, points_w, obs_uv, obs_mask = (_on(t, dev) for t in
                                        (T_wc, points_w, obs_uv, obs_mask))
    r, p_c = _residuals(T_wc, points_w, obs_uv, *_intrinsics(cam))
    m = obs_mask.to(r.dtype)
    n = torch.clamp(torch.sum(m, dim=0), min=1.0)                 # [L]
    err2 = torch.sum(m * torch.sum(r * r, dim=-1), dim=0) / n
    depth = torch.amin(
        torch.where(obs_mask, p_c[..., 2], torch.full_like(p_c[..., 2], float("inf"))),
        dim=0)
    return err2, depth
