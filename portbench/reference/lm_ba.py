"""Plain Levenberg-Marquardt bundle adjustment: the reference that decides
whether a solve of the benchmark is correct.

It states, in plain PyTorch and independently of the program, the problem
``svi_mapper_tpu_torch.solvers.ba.bundle_adjust`` solves and the LM
schedule it follows:

* stereo reprojection residuals ``[u_l, v_l, u_r, v_l] - obs`` of every
  observed (keyframe, landmark) pair, the pose ``T`` mapping world points
  into the camera; the robust weight ``k / |r|^2`` above ``|r|^2 = k``
  (Cauchy-like, the reference mapper's stereo edges), 1 below; chi^2 is
  the weighted sum of squares;
* the pose chain ``log(T_{k+1} T_k^-1 M_k^-1)`` with weight ``w_k``, its
  Jacobians taken as ``I`` and ``-Adj(T_{k+1} T_k^-1)`` under left updates;
* the gravity unary ``R_k (0, -1, 0) - d_k`` with weight ``g_k``;
* Gauss-Newton normal equations with the landmarks eliminated (Schur
  complement), ``lam`` on the pose blocks and ``lam + point_damping`` on
  the landmark blocks, fixed poses held by identity rows;
* a step is kept when it lowers chi^2; ``lam`` is multiplied by 0.3 then,
  by 8 otherwise; the loop stops after ``max_iterations`` or when a kept
  step gains less than ``min_rel_improvement``.

It works on the observed pairs only (a list, where the program works on
the dense ``[K, L]`` grid) and forms the reduced camera system as one
dense product. ``precision`` picks the arithmetic: ``"float64"`` is the
reference; ``"tf32"`` is the control, single precision with every
product's operands rounded to TF32's 10-bit mantissa as the card's TF32
mode rounds them (and, on a CUDA device, that mode switched on for the
products).

Imports torch and nothing of the program.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

PRECISIONS = ("float64", "tf32")
_DOWN = (0.0, -1.0, 0.0)


@dataclasses.dataclass
class Problem:
    """One solve's inputs, as the benchmark hands them to both sides."""

    T: torch.Tensor            # [K,4,4] initial poses (world -> camera)
    X: torch.Tensor            # [L,3] initial landmarks
    obs: torch.Tensor          # [K,L,4] observed u_l, v_l, u_r, v_l
    mask: torch.Tensor         # [K,L] bool
    fix: torch.Tensor          # [K] bool
    odo_M: torch.Tensor        # [K,4,4] chain measurements (entry k: k -> k+1)
    odo_w: torch.Tensor        # [K] chain weights (last unused)
    grav_d: torch.Tensor | None = None   # [K,3] measured down directions
    grav_w: torch.Tensor | None = None   # [K] their weights


@dataclasses.dataclass
class Settings:
    fx: float
    fy: float
    cx: float
    cy: float
    bq: float                  # right camera's P[0, 3] (-fx * baseline)
    kernel_px2: float
    lm_lambda0: float
    point_damping: float
    max_iterations: int
    min_rel_improvement: float


@dataclasses.dataclass
class Solution:
    T: torch.Tensor
    X: torch.Tensor
    chi2_final: float
    iterations: int


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Arith:
    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def ein(self, spec: str, *ops: torch.Tensor) -> torch.Tensor:
        """A product (einsum / matmul) in the chosen arithmetic."""
        if self.tf32:
            ops = tuple(_tf32(o) for o in ops)
        return torch.einsum(spec, *ops)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(t2):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3, by series below
    t^2 = 1e-4."""
    small = t2 < 1e-4
    s2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(s2)
    A = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720, (1 - torch.cos(t)) / s2)
    C = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040, (t - torch.sin(t)) / (s2 * t))
    return A, B, C


def exp_se3(xi):
    """Twist ``[rho, phi]`` -> 4x4."""
    rho, phi = xi[..., :3], xi[..., 3:]
    A, B, C = _coeffs((phi * phi).sum(-1))
    P = hat(phi)
    P2 = P @ P
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(P.shape)
    R = eye + A[..., None, None] * P + B[..., None, None] * P2
    V = eye + B[..., None, None] * P + C[..., None, None] * P2
    return make_T(R, (V @ rho[..., None])[..., 0])


def log_se3(T):
    """4x4 -> twist ``[rho, phi]`` (rotations well below pi)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2).clamp(-1, 1)
    theta = torch.acos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2
    small = theta < 1e-4
    sin = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    phi = torch.where(small[..., None], (1 + theta[..., None] ** 2 / 6) * w,
                      (theta / sin)[..., None] * w)
    t2 = (phi * phi).sum(-1)
    A, B, _ = _coeffs(t2)
    small2 = t2 < 1e-4
    coef = torch.where(small2, 1 / 12 + t2 / 720 + t2 * t2 / 30240,
                       (1 - A / (2 * torch.where(small2, torch.ones_like(B), B)))
                       / torch.where(small2, torch.ones_like(t2), t2))
    P = hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(P.shape)
    V_inv = eye - 0.5 * P + coef[..., None, None] * (P @ P)
    return torch.cat([(V_inv @ t[..., None])[..., 0], phi], -1)


def make_T(R, t):
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1
    return torch.cat([top, bottom], -2)


def inv_T(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def adjoint(T):
    """Adjoint of SE(3) for twists ``[rho, phi]``."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.cat([torch.cat([R, hat(t) @ R], -1),
                      torch.cat([torch.zeros_like(R), R], -1)], -2)


class _Solver:
    def __init__(self, p: Problem, s: Settings, ar: _Arith):
        self.s, self.ar = s, ar
        dt = ar.dtype
        self.K, self.L = p.mask.shape
        self.kl = p.mask.nonzero()                       # [N,2] observed pairs
        self.k, self.l = self.kl[:, 0], self.kl[:, 1]
        self.obs = p.obs.to(dt)[self.k, self.l]           # [N,4]
        self.free = (~p.fix).to(dt)
        self.odo_Minv = inv_T(p.odo_M.to(dt)[: self.K - 1])
        self.odo_w = p.odo_w.to(dt)[: self.K - 1]
        self.grav = None
        if p.grav_d is not None:
            self.grav = (p.grav_d.to(dt), p.grav_w.to(dt))
        self.down = torch.tensor(_DOWN, dtype=dt, device=p.mask.device)

    def _project(self, T, X):
        s = self.s
        R, t = T[self.k, :3, :3], T[self.k, :3, 3]
        pc = torch.einsum("nij,nj->ni", R, X[self.l]) + t
        z = pc[:, 2]
        z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        iz = 1 / z
        ul = s.fx * pc[:, 0] * iz + s.cx
        vl = s.fy * pc[:, 1] * iz + s.cy
        ur = (s.fx * pc[:, 0] + s.bq) * iz + s.cx
        return torch.stack([ul, vl, ur, vl], -1) - self.obs, pc, iz

    def _robust(self, r):
        e2 = (r * r).sum(-1)
        k = self.s.kernel_px2
        return torch.where(e2 > k, k / e2.clamp(min=1e-12), torch.ones_like(e2)), e2

    def chi2(self, T, X) -> torch.Tensor:
        r, _, _ = self._project(T, X)
        w, e2 = self._robust(r)
        c = (w * e2).sum()
        if self.K > 1:
            rc = log_se3(T[1:] @ inv_T(T[:-1]) @ self.odo_Minv)
            c = c + (self.odo_w * (rc * rc).sum(-1)).sum()
        if self.grav is not None:
            d, gw = self.grav
            rg = T[:, :3, :3] @ self.down - d
            c = c + (gw * (rg * rg).sum(-1)).sum()
        return c

    def step(self, T, X, lam):
        s, ar, K, L = self.s, self.ar, self.K, self.L
        dt, dev = ar.dtype, T.device
        r, pc, iz = self._project(T, X)
        w, _ = self._robust(r)
        w = w * (pc[:, 2] > 0.05).to(dt)
        x, y = pc[:, 0], pc[:, 1]
        zero = torch.zeros_like(x)
        Juv = torch.stack([
            torch.stack([s.fx * iz, zero, -s.fx * x * iz * iz], -1),
            torch.stack([zero, s.fy * iz, -s.fy * y * iz * iz], -1),
            torch.stack([s.fx * iz, zero, -(s.fx * x + s.bq) * iz * iz], -1),
            torch.stack([zero, s.fy * iz, -s.fy * y * iz * iz], -1)], -2)   # [N,4,3]
        eye3 = torch.eye(3, dtype=dt, device=dev).expand(pc.shape[0], 3, 3)
        Jp = ar.ein("nri,nij->nrj", Juv, torch.cat([eye3, -hat(pc)], -1))  # [N,4,6]
        Jl = ar.ein("nri,nij->nrj", Juv, T[self.k, :3, :3])              # [N,4,3]
        Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]

        H_pp = torch.zeros(K, 6, 6, dtype=dt, device=dev).index_add_(
            0, self.k, ar.ein("nra,nrb->nab", Jpw, Jp))
        b_p = torch.zeros(K, 6, dtype=dt, device=dev).index_add_(
            0, self.k, ar.ein("nra,nr->na", Jpw, r))
        H_ll = torch.zeros(L, 3, 3, dtype=dt, device=dev).index_add_(
            0, self.l, ar.ein("nra,nrb->nab", Jlw, Jl))
        b_l = torch.zeros(L, 3, dtype=dt, device=dev).index_add_(
            0, self.l, ar.ein("nra,nr->na", Jlw, r))
        H_pl = ar.ein("nra,nrb->nab", Jpw, Jl)                           # [N,6,3]
        H_ll = H_ll + (lam + s.point_damping) * torch.eye(3, dtype=dt, device=dev)
        Hinv = torch.linalg.inv(H_ll)                                    # [L,3,3]

        # the reduced camera system as one dense product: W [6K, 3L] and
        # C = W Hll^-1, both zero where no observation is
        W = torch.zeros(K, 6, L, 3, dtype=dt, device=dev)
        C = torch.zeros(K, 6, L, 3, dtype=dt, device=dev)
        W[self.k, :, self.l, :] = H_pl
        C[self.k, :, self.l, :] = ar.ein("nab,nbc->nac", H_pl, Hinv[self.l])
        W2, C2 = W.reshape(6 * K, 3 * L), C.reshape(6 * K, 3 * L)
        S = -ar.ein("ij,kj->ik", C2, W2).reshape(K, 6, K, 6)
        rhs = b_p - ar.ein("ij,j->i", C2, b_l.reshape(-1)).reshape(K, 6)
        kk = torch.arange(K, device=dev)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        S[kk, :, kk, :] += H_pp + lam * eye6

        if K > 1:
            D = T[1:] @ inv_T(T[:-1])
            ro = log_se3(D @ self.odo_Minv)                              # [K-1,6]
            Adj = adjoint(D)
            wo = self.odo_w
            a, b = kk[:-1], kk[1:]
            S[b, :, b, :] += wo[:, None, None] * eye6
            S[a, :, a, :] += wo[:, None, None] * ar.ein("kji,kjl->kil", Adj, Adj)
            S[a, :, b, :] -= wo[:, None, None] * Adj.transpose(1, 2)
            S[b, :, a, :] -= wo[:, None, None] * Adj
            rhs[b] += wo[:, None] * ro
            rhs[a] -= wo[:, None] * ar.ein("kji,kj->ki", Adj, ro)
        if self.grav is not None:
            d, gw = self.grav
            Rg = T[:, :3, :3] @ self.down
            A = -hat(Rg)
            S[kk, 3:, kk, 3:] += gw[:, None, None] * ar.ein("kji,kjl->kil", A, A)
            rhs[:, 3:] += gw[:, None] * ar.ein("kji,kj->ki", A, Rg - d)

        f = self.free
        S = S * f[:, None, None, None] * f[None, None, :, None]
        S[kk, :, kk, :] += (1 - f)[:, None, None] * eye6
        rhs = rhs * f[:, None]
        dp = -torch.linalg.solve(S.reshape(6 * K, 6 * K), rhs.reshape(-1))
        dp = dp.reshape(K, 6) * f[:, None]
        Wdp = ar.ein("ji,j->i", W2, dp.reshape(-1)).reshape(L, 3)
        dx = -torch.einsum("lab,lb->la", Hinv, b_l + Wdp)
        return exp_se3(dp) @ T, X + dx


def solve(p: Problem, s: Settings, precision: str = "float64") -> Solution:
    """The reference's solve of ``p``, on ``p``'s device."""
    ar = _Arith(precision)
    use_tf32 = ar.tf32 and p.mask.is_cuda
    ctx = contextlib.nullcontext()
    if use_tf32:
        ctx = _tf32_matmul()
    with ctx, torch.no_grad():
        sv = _Solver(p, s, ar)
        T, X = p.T.to(ar.dtype), p.X.to(ar.dtype)
        chi2 = sv.chi2(T, X)
        lam = s.lm_lambda0
        it = 0
        while it < s.max_iterations:
            Tn, Xn = sv.step(T, X, lam)
            cn = sv.chi2(Tn, Xn)
            accept = bool(cn < chi2)
            gain = float((chi2 - cn) / chi2.clamp(min=1e-12))
            if accept:
                T, X, chi2 = Tn, Xn, cn
            lam = lam * 0.3 if accept else lam * 8.0
            it += 1
            if accept and gain < s.min_rel_improvement:
                break
        return Solution(T=T, X=X, chi2_final=float(chi2), iterations=it)


@contextlib.contextmanager
def _tf32_matmul():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
