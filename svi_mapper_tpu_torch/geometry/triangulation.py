"""Multi-view triangulation + epipolar geometry, batched.

Replacement for the linear-triangulation and epipolar utilities of
``CMiniVisionToolbox`` (essential/fundamental from relative pose
CMiniVisionToolbox.h:50-52, linear stereo triangulation SVD/QR/LU/DLT variants
:54-56/:88-94, epipolar distance :57). The reference solves one 4x4 SVD per
point; here every variant is a closed-form batched solve over leading
dimensions. Matrix products run in full float32 (TF32 off on the card).
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.utils.device import require_fp32_matmul


def triangulate_dlt(
    P_left: torch.Tensor, P_right: torch.Tensor,
    uv_left: torch.Tensor, uv_right: torch.Tensor,
) -> torch.Tensor:
    """General DLT triangulation for (possibly unrectified) stereo.

    Builds the standard 4x4 homogeneous system (rows u*P3-P1, v*P3-P2 per
    view; ref CMiniVisionToolbox.cpp triangulation family) and solves the
    inhomogeneous 4x3 least-squares via normal equations — a batched 3x3
    solve instead of the reference's per-point Jacobi SVD
    (CMiniVisionToolbox.h:54).

    Args:
      P_left, P_right: (..., 3, 4) projection matrices (world or cam frame).
      uv_left, uv_right: (..., 2) pixel measurements.

    Returns:
      (..., 3) points in the frame the projection matrices map from.
    """
    require_fp32_matmul(uv_left)
    rows = []
    for P, uv in ((P_left, uv_left), (P_right, uv_right)):
        rows.append(uv[..., 0, None] * P[..., 2, :] - P[..., 0, :])
        rows.append(uv[..., 1, None] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)   # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", M, M)
    Atb = torch.einsum("...ki,...k->...i", M, b)
    # Levenberg damping keeps degenerate rays finite in float32.
    AtA = AtA + 1e-9 * torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


def essential_from_relative(T_ab: torch.Tensor) -> torch.Tensor:
    """Essential matrix of the relative pose a->b: E = [t]_x R
    (ref CMiniVisionToolbox.h:50)."""
    require_fp32_matmul(T_ab)
    R = T_ab[..., :3, :3]
    t = T_ab[..., :3, 3]
    return torch.matmul(se3.hat(t), R)


def fundamental_from_relative(
    T_ab: torch.Tensor, K_a: torch.Tensor, K_b: torch.Tensor
) -> torch.Tensor:
    """Fundamental matrix F = K_b^-T E K_a^-1 (ref CMiniVisionToolbox.h:51;
    used per detection point in CFundamentalMatcher.cpp:802-806)."""
    E = essential_from_relative(T_ab)
    Kbi = torch.linalg.inv(K_b).transpose(-1, -2)
    Kai = torch.linalg.inv(K_a)
    return torch.matmul(torch.matmul(Kbi, E), Kai)


def epipolar_line(F: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Line coefficients (a, b, c) in image b for pixels in image a:
    l = F @ [u, v, 1]."""
    require_fp32_matmul(F)
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", F, uv1)


def epipolar_distance(F: torch.Tensor, uv_a: torch.Tensor,
                      uv_b: torch.Tensor) -> torch.Tensor:
    """Point-to-epipolar-line distance in image b
    (ref CMiniVisionToolbox.h:57)."""
    l = epipolar_line(F, uv_a)
    uv1 = torch.cat([uv_b, torch.ones_like(uv_b[..., :1])], dim=-1)
    num = torch.abs(torch.sum(l * uv1, dim=-1))
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)
