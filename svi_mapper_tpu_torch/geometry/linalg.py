"""Closed-form small linear algebra for the GN solvers.

The 3x3/6x6 normal-equation systems every solver here builds are solved
with closed forms (adjugate, 3x3-block Schur elimination): pure elementwise
ops that batch over any leading shape, instead of a LU call per system.
All inputs are assumed damped SPD (every call site adds damping).
"""

from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse: ``[..., 3, 3] -> [..., 3, 3]``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    tiny = torch.where(det < 0, torch.full_like(det, -1e-20),
                       torch.full_like(det, 1e-20))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, tiny, det)
    adj = torch.stack([
        torch.stack([A, B, C], dim=-1),
        torch.stack([D, E, F], dim=-1),
        torch.stack([G, H, I], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def solve3x3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3] @ x = [..., 3]`` via the closed-form inverse."""
    return torch.einsum("...ij,...j->...i", inv3x3(M), b)


def solve6x6_spd(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a (damped) SPD ``[..., 6, 6]`` system by 3x3-block Schur
    elimination.

    M = [[A, B], [B^T, D]]; S = D - B^T A^-1 B;
    x2 = S^-1 (b2 - B^T A^-1 b1); x1 = A^-1 (b1 - B x2).
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ainv = inv3x3(A)
    AinvB = torch.einsum("...ij,...jk->...ik", Ainv, B)
    S = D - torch.einsum("...ji,...jk->...ik", B, AinvB)
    Ainv_b1 = torch.einsum("...ij,...j->...i", Ainv, b1)
    rhs2 = b2 - torch.einsum("...ji,...j->...i", B, Ainv_b1)
    x2 = solve3x3(S, rhs2)
    x1 = Ainv_b1 - torch.einsum("...ij,...j->...i", AinvB, x2)
    return torch.cat([x1, x2], dim=-1)


def cholesky_solve_or_nan(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``S^-1 rhs`` (``[n,n]``, ``[n]``) for a damped SPD system without a
    host read: where the factorisation fails the solution is NaN, as
    ``cho_factor`` gives it in the JAX package, and the caller's step is
    rejected or zeroed."""
    chol, info = torch.linalg.cholesky_ex(S, check_errors=False)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    return torch.cholesky_solve(rhs[:, None], chol)[:, 0]
