"""3D-3D point-cloud alignment (ICP with known correspondences), batched.

Replacement for the reference's loop-closure ICP (CTrackerGT.cpp:506-631):
Gauss-Newton on a 6-DoF transform aligning the matched landmark clouds of a
(query, reference) keyframe pair, with inverse-depth weighting, a 1.0 m^2
inlier kernel, and the acceptance gates >= 25 inliers and average inlier
error < 0.9 (gates :524-631).

The solver is written over a leading batch dimension so that ALL closure
candidates of a query keyframe validate at once. A candidate that has
converged is frozen while the others go on, so each candidate's
``iterations`` and ``T_qr`` equal those of its own unbatched call. The GN
loop is a Python loop with one host read per iteration (is any candidate
still active).
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.geometry import linalg, se3
from svi_mapper_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T_qr: torch.Tensor        # [4,4] transform mapping reference-cloud points
                              #       onto query-cloud points
    ok: torch.Tensor          # bool
    inliers: torch.Tensor     # int32
    avg_error: torch.Tensor   # average inlier squared error (m^2)
    iterations: torch.Tensor


def _align(p_query, p_ref, valid, T_init, inlier_m2, min_inliers,
           max_avg_error, max_iterations, convergence, damping) -> ICPResult:
    """The solver over ``[B, N, 3]`` clouds; every field of the result has
    the leading ``B``."""
    dtype = p_query.dtype
    dev = p_query.device
    B = p_query.shape[0]
    vm = valid.to(dtype)
    # inverse-depth information: 1/(1+z) on the query side
    w_depth = vm / (1.0 + torch.clamp(p_query[..., 2], min=0.0))
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(p_query.shape[:-1] + (3, 3))
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def step(T):
        q = se3.transform(T[:, None], p_ref)                  # [B,N,3]
        r = q - p_query
        err2 = torch.sum(r * r, dim=-1)
        w = w_depth * torch.where(err2 > inlier_m2,
                                  inlier_m2 / torch.clamp(err2, min=1e-12),
                                  torch.ones_like(err2))
        # J = d(T p)/d xi = [I | -hat(q)]
        J = torch.cat([eye3, -se3.hat(q)], dim=-1)            # [B,N,3,6]
        H = torch.einsum("bnri,bn,bnrj->bij", J, w, J)
        b = torch.einsum("bnri,bn,bnr->bi", J, w, r)
        xi = -linalg.solve6x6_spd(H + damping * eye6, b)
        return se3.apply_left_update(xi, T), torch.amax(torch.abs(xi), dim=-1)

    T = T_init
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.full((B,), max_iterations > 0, dtype=torch.bool, device=dev)
    while bool(active.any()):                    # the iteration's host read
        T_new, delta = step(T)
        T = torch.where(active[:, None, None], T_new, T)
        it = it + active.to(torch.int32)
        # a finished candidate stays finished: its pose no longer moves
        active = active & (it < max_iterations) & (delta > convergence)

    q = se3.transform(T[:, None], p_ref)
    err2 = torch.sum((q - p_query) ** 2, dim=-1)
    inlier = valid & (err2 < inlier_m2)
    n_in = torch.sum(inlier, dim=-1).to(torch.int32)
    avg = (torch.sum(torch.where(inlier, err2, torch.zeros_like(err2)), dim=-1)
           / torch.clamp(n_in, min=1))
    ok = ((n_in >= min_inliers) & (avg < max_avg_error)
          & torch.isfinite(T).all(dim=-1).all(dim=-1))
    return ICPResult(T_qr=T, ok=ok, inliers=n_in, avg_error=avg, iterations=it)


def align_clouds(
    p_query: torch.Tensor,     # [N,3] points in the query frame
    p_ref: torch.Tensor,       # [N,3] corresponding points in the reference frame
    valid: torch.Tensor,       # [N] bool correspondence mask
    *,
    T_init: torch.Tensor | None = None,
    inlier_m2: float = 1.0,          # ref inlier kernel 1.0 (CTrackerGT.cpp:524)
    min_inliers: int = 25,           # ref :527
    max_avg_error: float = 0.9,      # ref :528
    max_iterations: int = 20,
    convergence: float = 1e-5,
    damping: float = 1e-6,
    device=None,
) -> ICPResult:
    """Solve min_T sum w ||T p_ref - p_query||^2 with robust weights.

    Weights include the reference's inverse-depth factor (far points carry
    less information, CTrackerGT.cpp:535-560) and the 1 m^2 robust kernel.
    ``device=None`` means CUDA (raises without one)."""
    dev = resolve_device(device)
    p_query, p_ref, valid = (torch.as_tensor(t, device=dev)
                             for t in (p_query, p_ref, valid))
    if T_init is None:
        T_init = torch.eye(4, dtype=p_query.dtype, device=dev)
    res = _align(p_query[None], p_ref[None], valid[None],
                 torch.as_tensor(T_init, device=dev)[None], inlier_m2,
                 min_inliers, max_avg_error, max_iterations, convergence, damping)
    return ICPResult(**{f.name: getattr(res, f.name)[0]
                        for f in dataclasses.fields(res)})


def align_clouds_batch(p_query: torch.Tensor, p_ref: torch.Tensor,
                       valid: torch.Tensor, device=None) -> ICPResult:
    """:func:`align_clouds` with its default settings over a leading batch
    of candidates: ``[B,N,3]``, ``[B,N,3]``, ``[B,N]`` -> fields ``[B, ...]``."""
    dev = resolve_device(device)
    p_query, p_ref, valid = (torch.as_tensor(t, device=dev)
                             for t in (p_query, p_ref, valid))
    T_init = torch.eye(4, dtype=p_query.dtype, device=dev).repeat(
        p_query.shape[0], 1, 1)
    return _align(p_query, p_ref, valid, T_init, 1.0, 25, 0.9, 20, 1e-5, 1e-6)
