"""Plain Levenberg-Marquardt bundle adjustment of a whole map: the
reference that decides whether a whole-map solve of the benchmark is
correct.

The problem and the LM schedule are those of ``portbench/reference/lm_ba.py``
(residuals, robust weight, pose chain, gravity unary, damping, fixed poses,
accept / reject and the stop), and so are its precisions: ``"float64"`` is
the reference, ``"tf32"`` the control. Only the reduced camera system is
formed otherwise: where ``lm_ba.py`` forms ``W`` and ``C = W Hll^-1`` as
dense ``[6K, 3L]`` matrices, which at a whole map's size would take tens of
GB, this forms them a block of ``BLOCK`` landmarks at a time, over the
keyframes that observe the block, and adds each block's dense product into
``S``. The back-substitution runs over the observed pairs. At any size it
gives ``lm_ba.py``'s answers to float64 rounding.

Imports torch and nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference.lm_ba import (Problem, Settings, Solution, _Arith, _Solver,
                                       _tf32_matmul, adjoint, exp_se3, hat, inv_T, log_se3)

BLOCK = 2048


class _MapSolver(_Solver):
    def __init__(self, p: Problem, s: Settings, ar: _Arith):
        super().__init__(p, s, ar)
        # the observed pairs by landmark, so that a block of landmarks is a
        # run of the list
        order = torch.argsort(self.l * self.K + self.k)
        self.k, self.l, self.obs = self.k[order], self.l[order], self.obs[order]
        edges = torch.arange(0, self.L + BLOCK, BLOCK, device=self.l.device).clamp(max=self.L)
        self.runs = torch.searchsorted(self.l, edges).tolist()

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
        Cn = ar.ein("nab,nbc->nac", H_pl, Hinv[self.l])                  # [N,6,3]

        # the reduced camera system, a block of landmarks at a time: W and
        # C dense over the block's keyframes and landmarks, zero where no
        # observation is
        S = torch.zeros(K, 6, K, 6, dtype=dt, device=dev)
        rhs = b_p.clone()
        for a, b in zip(self.runs[:-1], self.runs[1:]):
            if a == b:
                continue
            kb, lb = self.k[a:b], self.l[a:b]
            ks, kloc = torch.unique(kb, return_inverse=True)
            l0 = int(lb[0])
            nl = int(lb[-1]) - l0 + 1
            W = torch.zeros(ks.numel(), 6, nl, 3, dtype=dt, device=dev)
            C = torch.zeros_like(W)
            W[kloc, :, lb - l0, :] = H_pl[a:b]
            C[kloc, :, lb - l0, :] = Cn[a:b]
            W2, C2 = W.reshape(6 * ks.numel(), 3 * nl), C.reshape(6 * ks.numel(), 3 * nl)
            block = -ar.ein("ij,kj->ik", C2, W2).reshape(ks.numel(), 6, ks.numel(), 6)
            S[ks[:, None], :, ks[None, :], :] += block.permute(0, 2, 1, 3)
            rhs[ks] -= ar.ein("ij,j->i", C2, b_l[l0: l0 + nl].reshape(-1)).reshape(-1, 6)
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
        Wdp = torch.zeros(L, 3, dtype=dt, device=dev).index_add_(
            0, self.l, ar.ein("nab,na->nb", H_pl, dp[self.k]))
        dx = -torch.einsum("lab,lb->la", Hinv, b_l + Wdp)
        return exp_se3(dp) @ T, X + dx


def solve(p: Problem, s: Settings, precision: str = "float64") -> Solution:
    """The reference's solve of ``p``, on ``p``'s device."""
    ar = _Arith(precision)
    ctx = _tf32_matmul() if ar.tf32 and p.mask.is_cuda else contextlib.nullcontext()
    with ctx, torch.no_grad():
        sv = _MapSolver(p, s, ar)
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
