"""SE(3) / SO(3) Lie-group operations, batched over leading dimensions.

Replaces the reference's hand-rolled pose algebra (``CMiniVisionToolbox``:
Rodrigues conversions, skew matrix, se(3)-vector-to-isometry, and the
rotation re-orthogonalization ``R -= 0.5 R (R^T R - I)`` of
``CSolverStereoPosit.cpp:108-114``).

Poses are 4x4 homogeneous matrices (``T @ [x,1]``); twists are 6-vectors
``[rho, phi]`` (translation part first). No function contains
data-dependent Python control flow: small-angle branches are ``torch.where``
with Taylor fallbacks that are safe in float32. All matrix products are
float32 (PyTorch keeps TF32 off for matmul by default).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
_LOG_SE3_TAYLOR = 1e-4     # theta^2 below which log_se3 takes its series


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (ref CMiniVisionToolbox.h:48)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe."""
    small = theta_sq < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    A, B, _ = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    return (_eye_like(Phi) + A[..., None, None] * Phi
            + B[..., None, None] * (Phi @ Phi))


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues), careful
    around theta = 0 and theta = pi in float32."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)

    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    one = torch.ones_like(theta)

    safe_sin = torch.where(small | near_pi, one, sin_theta)
    phi_generic = (theta / safe_sin)[..., None] * w
    phi_small = (1.0 + theta[..., None] ** 2 / 6.0) * w
    # near pi: axis from the symmetric part,
    # axis_i^2 = (R_ii - cos) / (1 - cos)
    one_minus_cos = torch.where(near_pi, 1.0 - cos_theta, one)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0, 1.0)
    axis_abs = torch.sqrt(axis_sq)
    s = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sym = torch.stack(
        [
            R[..., 1, 0] + R[..., 0, 1],
            R[..., 2, 1] + R[..., 1, 2],
            R[..., 0, 2] + R[..., 2, 0],
        ],
        dim=-1,
    )  # [xy, yz, zx] pair products * 2(1-cos)
    dominant = torch.argmax(axis_abs, dim=-1)

    # the dominant axis takes the sign of s (+ if s ~ 0); the others follow
    # through the pair products: sign(x*y) = sign(sym_xy) etc.
    s_dom = torch.gather(s, -1, dominant[..., None])[..., 0]
    d_sign = torch.where(s_dom >= 0, one, -one)
    signs = []
    for i in range(3):
        same = dominant == i
        pair_idx = torch.where(
            ((dominant == 0) & (i == 1)) | ((dominant == 1) & (i == 0)),
            torch.zeros_like(dominant),
            torch.where(
                ((dominant == 1) & (i == 2)) | ((dominant == 2) & (i == 1)),
                torch.ones_like(dominant), torch.full_like(dominant, 2)),
        )
        pair = torch.gather(sym, -1, pair_idx[..., None])[..., 0]
        signs.append(torch.where(
            same, d_sign, d_sign * torch.where(pair >= 0, one, -one)))
    axis_pi = axis_abs * torch.stack(signs, dim=-1)
    phi_pi = theta[..., None] * axis_pi

    return torch.where(
        small[..., None], phi_small,
        torch.where(near_pi[..., None], phi_pi, phi_generic))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist ``[rho, phi]`` -> 4x4 isometry (exact exponential)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1)
    A, B, C = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    eye = _eye_like(Phi)
    R = eye + A[..., None, None] * Phi + B[..., None, None] * Phi2
    V = eye + B[..., None, None] * Phi + C[..., None, None] * Phi2
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """4x4 isometry -> twist ``[rho, phi]`` (inverse of :func:`exp_se3`)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    theta_sq = torch.sum(phi * phi, dim=-1)
    A, B, _ = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    # Taylor branch up to theta = 1e-2: in float32 ``1 - A / (2 B)`` has no
    # digits left below that (``1 - cos`` rounds to 0 or one ulp near
    # theta = 2e-4, which gives NaN or a translation off by centimetres —
    # as the JAX package's ``log_se3``, with its 1e-4 threshold, does)
    small = theta_sq < _LOG_SE3_TAYLOR
    safe_t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_B = torch.where(small, torch.ones_like(B), B)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - A / (2.0 * safe_B)) / safe_t2)
    V_inv = _eye_like(Phi) - 0.5 * Phi + coef[..., None, None] * Phi2
    rho = (V_inv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


_bottom_rows: dict[tuple[torch.device, torch.dtype], torch.Tensor] = {}


def _bottom_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The row ``[0, 0, 0, 1]``, made on ``device``: no copy from the host,
    which a CUDA-graph capture refuses. Kept per device and dtype once made
    outside a capture (one made inside belongs to the graph's memory and
    holds its values only when the graph replays)."""
    row = _bottom_rows.get((device, dtype))
    if row is None:
        row = torch.eye(4, dtype=dtype, device=device)[3]
        if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
            _bottom_rows[(device, dtype)] = row
    return row


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 isometries from rotations and translations."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _bottom_row(R.dtype, R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Fast inverse of an isometry (R^T, -R^T t)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply isometries to 3D points: ``T[..., :3, :3] @ p + t``."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def reorthogonalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step ``R -= 0.5 R (R^T R - I)`` back onto SO(3)
    (ref CSolverStereoPosit.cpp:108-114)."""
    return R - 0.5 * (R @ (R.transpose(-1, -2) @ R - _eye_like(R)))


def apply_left_update(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """GN left-multiplicative update ``exp(xi) @ T`` with
    re-orthogonalization."""
    T_new = exp_se3(xi) @ T
    R = reorthogonalize(T_new[..., :3, :3])
    return make_T(R, T_new[..., :3, 3])


def quat_to_R(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w — the calibration files' order) -> rotation."""
    q = q_xyzw / torch.linalg.norm(q_xyzw, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotation_geodesic_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle of Ra^T Rb — the KITTI rotation-error formula:
    acos((trace - 1) / 2)."""
    Rrel = Ra.transpose(-1, -2) @ Rb
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return torch.acos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))
