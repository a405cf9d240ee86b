"""Trajectory evaluation (numpy only; the port's own copy of the JAX
package's ``eval/trajectory.py``, held against it by the tests).

Replaces the reference's ``evaluate_trajectory`` runnable
(evaluate_trajectory.cpp:196-303): per-frame *relative* translation error
(L1 metres and ratio of motion) and rotation error (the KITTI
``acos((trace-1)/2)`` formula, :287-303), with totals/averages and the
"relative translation precision = 1 - avg rel err" summary (:270-284) —
plus absolute-trajectory-error RMSE with SE(3) (Umeyama) alignment, the
standard SLAM headline number the reference never computed.

Also reads/writes KITTI-format trajectory files (12 numbers per line:
row-major 3x4 of T_cam->world), the format of ``CLogTrajectoryKITTI``
(CLogger.h:264-302).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class TrajectoryMetrics:
    ate_rmse_m: float
    rel_trans_err_m: float       # average per-frame relative translation L1
    rel_trans_ratio: float       # average ratio vs GT motion
    rel_rot_err_rad: float       # average per-frame rotation error
    precision: float             # 1 - rel_trans_ratio (ref summary line)
    n_frames: int


def _positions(T_wc: np.ndarray) -> np.ndarray:
    """Camera centers in world coordinates from world->camera transforms."""
    R = T_wc[:, :3, :3]
    t = T_wc[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def umeyama_alignment(p_est: np.ndarray, p_gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid SE(3) alignment (no scale) minimizing ||R p_est + t - p_gt||."""
    mu_e = p_est.mean(0)
    mu_g = p_gt.mean(0)
    cov = (p_gt - mu_g).T @ (p_est - mu_e) / len(p_est)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(T_est_wc: np.ndarray, T_gt_wc: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over camera centers (metres)."""
    p_e = _positions(T_est_wc)
    p_g = _positions(T_gt_wc)
    if align and len(p_e) >= 3:
        R, t = umeyama_alignment(p_e, p_g)
        p_e = p_e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_e - p_g) ** 2, axis=-1))))


def rotation_error(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """KITTI rotation error acos((trace(Ra^T Rb) - 1)/2)
    (ref evaluate_trajectory.cpp:287-303)."""
    Rrel = np.einsum("nji,njk->nik", Ra, Rb)
    tr = np.trace(Rrel, axis1=-2, axis2=-1)
    return np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0))


def evaluate(T_est_wc: np.ndarray, T_gt_wc: np.ndarray) -> TrajectoryMetrics:
    """Full metric block mirroring evaluate_trajectory.cpp:196-284."""
    n = len(T_est_wc)
    assert len(T_gt_wc) == n and n >= 2
    # camera->world ("pose") transforms
    P_e = np.linalg.inv(T_est_wc)
    P_g = np.linalg.inv(T_gt_wc)
    # per-frame relative motions
    d_e = np.einsum("nij,njk->nik", np.linalg.inv(P_e[:-1]), P_e[1:])
    d_g = np.einsum("nij,njk->nik", np.linalg.inv(P_g[:-1]), P_g[1:])
    dt = np.linalg.norm(d_e[:, :3, 3] - d_g[:, :3, 3], axis=-1)
    motion = np.maximum(np.linalg.norm(d_g[:, :3, 3], axis=-1), 1e-9)
    rot_err = rotation_error(d_e[:, :3, :3], d_g[:, :3, :3])
    ratio = float(np.mean(dt / motion))
    return TrajectoryMetrics(
        ate_rmse_m=ate_rmse(T_est_wc, T_gt_wc),
        rel_trans_err_m=float(np.mean(dt)),
        rel_trans_ratio=ratio,
        rel_rot_err_rad=float(np.mean(rot_err)),
        precision=1.0 - ratio,
        n_frames=n,
    )


# ---------------------------------------------------------------------------
# alignment + resampling (the compute_rotation_icp / interpolate_trajectory
# runnables, compute_rotation_icp.cpp, interpolate_trajectory.cpp)
# ---------------------------------------------------------------------------

def align_trajectory(T_est_wc: np.ndarray, T_gt_wc: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rigidly align the estimated trajectory onto the ground truth
    (the ``compute_rotation_icp`` trajectory-alignment tool): returns
    ``(T_est_aligned_wc, R, t)`` where camera centers map as
    ``p' = R p + t``."""
    p_e = _positions(T_est_wc)
    p_g = _positions(T_gt_wc)
    R, t = umeyama_alignment(p_e, p_g)
    # world-frame similarity G (rotation+translation) applied to poses:
    # p_w' = R p_w + t  =>  T_wc' = T_wc G^-1 with G = [R t; 0 1]
    G = np.eye(4)
    G[:3, :3] = R
    G[:3, 3] = t
    Ginv = np.linalg.inv(G)
    return np.einsum("nij,jk->nik", T_est_wc, Ginv), R, t


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrices [N,3,3] -> unit quaternions [N,4] (w,x,y,z)."""
    N = R.shape[0]
    q = np.zeros((N, 4))
    tr = np.trace(R, axis1=-2, axis2=-1)
    for i in range(N):  # small N — host-side tool path
        m = R[i]
        if tr[i] > 0:
            s = np.sqrt(tr[i] + 1.0) * 2
            q[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s,
                    (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        else:
            k = np.argmax(np.diagonal(m))
            a, b, c = k, (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(1.0 + m[a, a] - m[b, b] - m[c, c]) * 2
            v = np.zeros(4)
            v[0] = (m[c, b] - m[b, c]) / s
            v[1 + a] = 0.25 * s
            v[1 + b] = (m[b, a] + m[a, b]) / s
            v[1 + c] = (m[c, a] + m[a, c]) / s
            q[i] = v
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def interpolate_trajectory(
    times_src: np.ndarray, T_wc_src: np.ndarray, times_dst: np.ndarray
) -> np.ndarray:
    """Resample a trajectory to a new timebase (the ``interpolate_trajectory``
    runnable, interpolate_trajectory.cpp): linear interpolation of camera
    centers, slerp of orientations, clamped extrapolation at the ends."""
    P = np.linalg.inv(T_wc_src)              # camera->world poses
    pos = P[:, :3, 3]
    quat = _quat_from_R(P[:, :3, :3])
    # enforce quaternion hemisphere continuity for slerp
    for i in range(1, len(quat)):
        if np.dot(quat[i], quat[i - 1]) < 0:
            quat[i] = -quat[i]

    idx = np.clip(np.searchsorted(times_src, times_dst, side="right") - 1,
                  0, len(times_src) - 2)
    t0, t1 = times_src[idx], times_src[idx + 1]
    a = np.clip((times_dst - t0) / np.maximum(t1 - t0, 1e-12), 0.0, 1.0)

    p = pos[idx] * (1 - a)[:, None] + pos[idx + 1] * a[:, None]
    q0, q1 = quat[idx], quat[idx + 1]
    dot = np.clip(np.sum(q0 * q1, axis=-1), -1.0, 1.0)
    theta = np.arccos(np.abs(dot))
    small = theta < 1e-6
    s0 = np.where(small, 1 - a, np.sin((1 - a) * theta) / np.maximum(np.sin(theta), 1e-12))
    s1 = np.where(small, a, np.sin(a * theta) / np.maximum(np.sin(theta), 1e-12))
    q = q0 * s0[:, None] + q1 * s1[:, None]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)

    out = np.tile(np.eye(4), (len(times_dst), 1, 1))
    out[:, :3, :3] = _R_from_quat(q)
    out[:, :3, 3] = p
    return np.linalg.inv(out).astype(np.float32)   # back to world->camera


# ---------------------------------------------------------------------------
# KITTI trajectory file I/O (format of CLogger.h:264-302)
# ---------------------------------------------------------------------------

def save_kitti_trajectory(path: str | Path, T_wc: np.ndarray) -> None:
    """Write camera->world 3x4 rows, 12 numbers per line (KITTI format)."""
    P = np.linalg.inv(T_wc)  # camera->world
    with open(path, "w") as f:
        for T in P:
            f.write(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)) + "\n")


def load_kitti_trajectory(path: str | Path) -> np.ndarray:
    """Read a KITTI trajectory file -> world->camera transforms [N,4,4]."""
    rows = []
    for line in Path(path).read_text().splitlines():
        vals = [float(x) for x in line.split()]
        if len(vals) != 12:
            continue
        T = np.eye(4)
        T[:3] = np.asarray(vals).reshape(3, 4)
        rows.append(np.linalg.inv(T))
    return np.stack(rows).astype(np.float32)
