"""Pose-graph optimization: batched robust Gauss-Newton over SE(3) chains.

Replacement for the reference's trajectory-only g2o graph
(Cg2oOptimizer.cpp:92-96: BlockSolver_6_3 + CHOLMOD + Gauss-Newton, run
after loop-closure consensus, :342-360) with its pose-pose ``EdgeSE3``
measurements (information 1e5*I scaled down by 1/(1+||dt||^2), :1258-1266)
and z-damped loop-closure edges (:1075-1133).

Poses and edges are fixed-capacity masked tensors; each GN iteration
evaluates every edge residual r = log(T_j inv(T_i) inv(M_ij)) in batch,
adds the standard (J_j = I, J_i = -Ad(M_ij)) block contributions into a
dense [6N, 6N] system and solves by Cholesky — N is the keyframe count
(hundreds), so the dense solve is small.

The edges' blocks are added with ``index_put_(accumulate=True)``; several
edges share a pose, and on a CUDA device such repeated indices are summed in
no fixed order, so two runs of the same graph can differ in the last bits of
``H`` (a float32 sum of at most a few dozen terms per entry: ~1e-6
relative). The GN loop is a Python loop with one host read per iteration
(the step size against ``convergence``).
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.geometry import linalg, se3
from svi_mapper_tpu_torch.utils.device import require_fp32_matmul, resolve_device


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [rho, phi]: [[R, hat(t)R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = se3.hat(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


@dataclasses.dataclass(frozen=True)
class PoseGraphEdges:
    """Fixed-capacity edge set (sequential odometry + loop closures)."""

    i: torch.Tensor          # [E] int32 source pose index
    j: torch.Tensor          # [E] int32 target pose index
    T_ij: torch.Tensor       # [E,4,4] measured relative transform T_j @ inv(T_i)
    weight: torch.Tensor     # [E] information scale
    valid: torch.Tensor      # [E] bool
    # optional per-component diagonal information (twist order [rho, phi]),
    # multiplied into ``weight``: the anisotropic analog of the reference's
    # 6x6 edge information matrices — loop-closure edges damp the
    # translation-z component by 100 (_getInformationNoZ,
    # Cg2oOptimizer.cpp:1542-1550, applied :1075-1133) because ICP depth
    # along the optical axis is the noisy direction. None = isotropic.
    info6: torch.Tensor | None = None   # [E,6]

    def to(self, device) -> "PoseGraphEdges":
        return PoseGraphEdges(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class GravityPriors:
    """Per-pose gravity-direction measurements — the unary edge
    ``EdgeSE3LinearAcceleration`` (edge_se3_linear_acceleration.cpp:106-116:
    error = R a_measured - (0, 0, -1); here the world 'up' is (0, -1, 0) in
    the y-down camera convention)."""

    down_cam: torch.Tensor    # [N,3] unit gravity direction measured in camera frame
    weight: torch.Tensor      # [N]
    valid: torch.Tensor       # [N] bool

    def to(self, device) -> "GravityPriors":
        return GravityPriors(self.down_cam.to(device), self.weight.to(device),
                             self.valid.to(device))


@dataclasses.dataclass(frozen=True)
class PoseGraphResult:
    T_wc: torch.Tensor       # [N,4,4]
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: torch.Tensor


def make_edges(capacity: int, dtype=torch.float32, device=None) -> PoseGraphEdges:
    dev = resolve_device(device)
    return PoseGraphEdges(
        i=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        j=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        T_ij=torch.eye(4, dtype=dtype, device=dev).repeat(capacity, 1, 1),
        weight=torch.zeros((capacity,), dtype=dtype, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def sequential_edge_weight(T_ij: torch.Tensor) -> torch.Tensor:
    """Reference's odometry information scaling 1/(1 + ||dt||^2)
    (Cg2oOptimizer.cpp:1258-1266)."""
    dt2 = torch.sum(T_ij[..., :3, 3] ** 2, dim=-1)
    return 1.0 / (1.0 + dt2)


def _edge_residuals(T_wc, edges):
    """r [E,6] for all edges."""
    Ti = T_wc[edges.i.long()]
    Tj = T_wc[edges.j.long()]
    E = (Tj @ se3.inv_T(Ti)) @ se3.inv_T(edges.T_ij)
    return se3.log_se3(E)


def optimize_pose_graph(
    T_wc: torch.Tensor,         # [N,4,4] initial poses (world->camera)
    edges: PoseGraphEdges,
    fix_mask: torch.Tensor,     # [N] bool — gauge-fixed poses
    *,
    gravity: GravityPriors | None = None,
    robust_delta: float = 0.5,  # Cauchy-style kernel on ||r||^2
    max_iterations: int = 20,
    damping: float = 1e-4,
    convergence: float = 1e-6,
    trust_radius: float = 1.0,  # per-iteration update clamp (GN trust region)
    device=None,
) -> PoseGraphResult:
    """``device=None`` means CUDA (raises without one); inputs are moved
    there."""
    dev = resolve_device(device)
    T_wc = torch.as_tensor(T_wc, device=dev)
    fix_mask = torch.as_tensor(fix_mask, device=dev)
    edges = edges.to(dev)
    if gravity is not None:
        gravity = gravity.to(dev)
    require_fp32_matmul(T_wc)
    N = T_wc.shape[0]
    dtype = T_wc.dtype
    ei, ej = edges.i.long(), edges.j.long()
    ew = edges.weight * edges.valid.to(dtype)
    # per-component diagonal information (isotropic when info6 is None)
    i6 = (torch.ones(edges.T_ij.shape[:1] + (6,), dtype=dtype, device=dev)
          if edges.info6 is None else edges.info6.to(dtype))
    w6_base = ew[:, None] * i6                                   # [E,6]
    down_w = torch.tensor([0.0, -1.0, 0.0], dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    nn = torch.arange(N, device=dev)
    free = (~fix_mask).to(dtype)
    J_i = -adjoint(edges.T_ij)                                   # [E,6,6]
    if gravity is not None:
        gw = gravity.weight * gravity.valid.to(dtype)

    def gravity_residual(T):
        # r = R_wc down_world - down_measured (unary, rotation-only)
        Rg = torch.einsum("nij,j->ni", T[:, :3, :3], down_w)
        return Rg, Rg - gravity.down_cam

    def chi2_of(T):
        r = _edge_residuals(T, edges)
        c = torch.sum(w6_base * r * r)
        if gravity is not None:
            _, rg = gravity_residual(T)
            c = c + torch.sum(gw * torch.sum(rg * rg, dim=-1))
        return c

    chi2_init = chi2_of(T_wc)

    def gn_step(T):
        r = _edge_residuals(T, edges)                            # [E,6]
        # robust kernel on the info-weighted residual r^T Omega r (g2o
        # semantics; Omega here = diag(i6) without the edge weight so the
        # kernel cutoff stays comparable across edges): a z-damped closure
        # edge with large optical-axis error keeps its well-conditioned
        # x/y information instead of tripping the cutoff.
        err2 = torch.sum(i6 * r * r, dim=-1)
        rob = torch.where(err2 > robust_delta,
                          robust_delta / torch.clamp(err2, min=1e-12),
                          torch.ones_like(err2))
        w6 = w6_base * rob[:, None]                              # [E,6]
        # per-edge blocks under the diagonal information W = diag(w6)
        H_ii = torch.einsum("eki,ek,ekj->eij", J_i, w6, J_i)
        H_jj = w6[:, :, None] * eye6
        # off-diagonal block H_ij = J_i^T W J_j with J_j = I -> J_i^T diag(w6)
        H_ij_blk = J_i.transpose(-1, -2) * w6[:, None, :]
        b_i = torch.einsum("eki,ek,ek->ei", J_i, w6, r)
        b_j = w6 * r

        # blocks first ([N, N, 6, 6]) so that one index pair names a block
        H = torch.zeros((N, N, 6, 6), dtype=dtype, device=dev)
        H.index_put_((ei, ei), H_ii, accumulate=True)
        H.index_put_((ej, ej), H_jj, accumulate=True)
        H.index_put_((ei, ej), H_ij_blk, accumulate=True)
        H.index_put_((ej, ei), H_ij_blk.transpose(-1, -2), accumulate=True)
        b = torch.zeros((N, 6), dtype=dtype, device=dev)
        b.index_add_(0, ei, b_i)
        b.index_add_(0, ej, b_j)

        if gravity is not None:
            Rg, rg = gravity_residual(T)                         # [N,3]
            # J = [0 | -hat(R down_w)] (3x6) — translation-independent
            Jg = torch.cat(
                [torch.zeros((N, 3, 3), dtype=dtype, device=dev), -se3.hat(Rg)],
                dim=-1)
            H[nn, nn] += torch.einsum("nki,n,nkj->nij", Jg, gw, Jg)
            b = b + torch.einsum("nki,n,nk->ni", Jg, gw, rg)

        H = H * free[:, None, None, None] * free[None, :, None, None]
        H[nn, nn] += eye6[None] * ((1.0 - free) + damping)[:, None, None]
        b = b * free[:, None]

        # damped SPD system; a failed factorisation gives NaN, which the
        # finiteness guard below turns into a zero step (no host read)
        xi = -linalg.cholesky_solve_or_nan(
            H.permute(0, 2, 1, 3).reshape(N * 6, N * 6), b.reshape(N * 6)).reshape(N, 6)
        xi = xi * free[:, None]
        # trust region: scale the whole update down if any pose step is huge
        step = torch.max(torch.abs(xi))
        scale = torch.clamp(trust_radius / torch.clamp(step, min=1e-12), max=1.0)
        xi = xi * scale
        xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
        return se3.apply_left_update(xi, T), torch.max(torch.abs(xi))

    T = T_wc
    iters = 0
    while iters < max_iterations:
        T, delta = gn_step(T)
        iters += 1
        if not bool(delta > convergence):        # the iteration's host read
            break

    return PoseGraphResult(
        T_wc=T, chi2_initial=chi2_init, chi2_final=chi2_of(T),
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
    )
