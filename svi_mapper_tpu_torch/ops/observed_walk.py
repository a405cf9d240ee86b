"""The card's kernel route of bundle adjustment over the observed slots
only: its chi^2 and its back-substitution, two entries of one CUDA source
(``csrc/observed_walk.cu``), and their plain versions.

``solvers.ba._CardKernelBuffers`` takes both in place of the dense
``[K, L]`` passes the other routes keep:

  * :func:`observed_chi2`: the reprojection part of ``total_chi2``,
    ``sum over observed (k, l) of w(err2) obs_w err2`` with ``err2`` the
    squared stereo residual of landmark ``l`` in keyframe ``k`` and ``w``
    the robust weight (``_project`` -> ``robust_w`` -> ``_chi2`` of
    ``solvers.ba``), per slot in float32, summed in float64 in a fixed
    order, returned as a float32 0-d tensor;
  * :func:`observed_update`: the landmark half of ``update``,
    ``X - Hll_inv (b_l + W^T dp)`` with ``W^T dp`` summed per landmark over
    its observing keyframes from the ``[3, 6K, L]`` W planes K4 / K5 write.

An entry launches the kernel for CUDA tensors (or raises) and takes its
plain version only for CPU tensors. ``out=`` (and the chi^2's float64
``scratch=`` of :func:`chi2_blocks` partials) are the caller's buffers,
which keep the results at fixed addresses inside a CUDA graph; the plain
versions copy into ``out``. Neither entry reads anything to the host, so
both are captured in the LM loop's graphs. A slot whose ``obs_w`` is 0 is
skipped: what the dense passes add there is exactly 0 (W vanishes with the
weight), so the results differ from the dense passes only by the order of
the sums.

Replaces no TPU kernel (the JAX package computes both densely); why it
was added, its design and its bound are in the source's note. No kernel
name contains ``schur_``: ``schur_roofline_pct.ba`` times every such kernel
as K4 / K5's.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths

WALK_LANDMARKS = 32          # landmarks a block walks (the kernels' WL)

observed_chi2_launches = 0
observed_update_launches = 0


def chi2_blocks(L: int) -> int:
    """The chi^2 kernel's blocks, and float64 partials, for ``L`` landmarks."""
    return -(-L // WALK_LANDMARKS)


def _observed(obs_w: torch.Tensor):
    """The observed slots ``(k, l)``, by keyframe, then landmark."""
    return torch.nonzero(obs_w, as_tuple=True)


def observed_chi2_plain(T_wc, points_w, obs_uv, obs_w, *, fx, fy, cx, cy, bq,
                        kernel_px2):
    """Plain PyTorch version of :func:`observed_chi2` (any float dtype)."""
    k, l = _observed(obs_w)
    R, t, X = T_wc[k, :3, :3], T_wc[k, :3, 3], points_w[l]
    p_c = (R * X[:, None, :]).sum(-1) + t
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    r = torch.stack([u_l, v_l, u_r, v_l], dim=-1) - obs_uv[k, l]
    err2 = torch.sum(r * r, dim=-1)
    w = torch.where(err2 > kernel_px2, kernel_px2 / torch.clamp(err2, min=1e-12),
                    torch.ones_like(err2))
    return torch.sum(((w * obs_w[k, l]) * err2).double()).to(points_w.dtype)


def observed_update_plain(W, dp, Hll_inv, b_l, points_w, obs_w):
    """Plain PyTorch version of :func:`observed_update` (any float dtype)."""
    K, L = obs_w.shape
    k, l = _observed(obs_w)
    Wkl = W.view(3, K, 6, L)[:, k, :, l]                         # [N, 3, 6]
    Wt_dp = torch.zeros_like(b_l).index_add_(0, l, (Wkl * dp[k][:, None, :]).sum(-1))
    return points_w - (Hll_inv @ (b_l + Wt_dp)[..., None])[..., 0]


def _check(name: str, dev: torch.device, **tensors) -> None:
    for nm, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {nm} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous float32 tensor, got "
                             f"{t.dtype}{'' if t.is_contiguous() else ', not contiguous'}")


def _count(entry: str, work) -> None:
    # a launch recorded into a CUDA graph runs at each replay, where no
    # Python runs: the launches counted here are the ones made directly
    if not torch.cuda.is_current_stream_capturing():
        paths.count_launch(__name__, entry, work=work)


def observed_chi2(T_wc, points_w, obs_uv, obs_w, *, fx, fy, cx, cy, bq, kernel_px2,
                  out=None, scratch=None):
    """The robust reprojection chi^2 of poses ``T_wc [K, 4, 4]`` and
    landmarks ``points_w [L, 3]`` over the slots where ``obs_w [K, L]`` (the
    observation mask times any information scale) is not 0, observations
    ``obs_uv [K, L, 4]``. Into ``out`` (a 0-d float32 tensor) where given;
    ``scratch``: float64 ``[chi2_blocks(L)]`` for the card's partial sums
    (the plain version needs none)."""
    if not T_wc.is_cuda:
        got = observed_chi2_plain(T_wc, points_w, obs_uv, obs_w, fx=fx, fy=fy, cx=cx,
                                  cy=cy, bq=bq, kernel_px2=kernel_px2)
        return got if out is None else out.copy_(got)
    K, L = obs_w.shape
    dev = T_wc.device
    if (T_wc.shape != (K, 4, 4) or points_w.shape != (L, 3)
            or obs_uv.shape != (K, L, 4) or K < 1 or L < 1):
        raise ValueError(
            f"observed_chi2: shapes T_wc {tuple(T_wc.shape)}, points_w "
            f"{tuple(points_w.shape)}, obs_uv {tuple(obs_uv.shape)}, obs_w "
            f"{tuple(obs_w.shape)} do not form a [K, L] window")
    if out is None:
        out = torch.empty((), dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(chi2_blocks(L), dtype=torch.float64, device=dev)
    _check("observed_chi2", dev, T_wc=T_wc, points_w=points_w, obs_uv=obs_uv, obs_w=obs_w,
           out=out)
    if (scratch.device != dev or scratch.dtype != torch.float64
            or scratch.shape != (chi2_blocks(L),) or not scratch.is_contiguous()):
        raise ValueError(f"observed_chi2: scratch must be float64 [{chi2_blocks(L)}] on {dev}")
    if obs_uv.data_ptr() % 16 or out.shape != ():
        raise ValueError("observed_chi2: obs_uv must be 16-byte aligned, out a 0-d tensor")
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        err = lib.svi_observed_chi2(
            T_wc.data_ptr(), points_w.data_ptr(), obs_uv.data_ptr(), obs_w.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), K, L, float(fx), float(fy), float(cx),
            float(cy), float(bq), float(kernel_px2), torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "svi_observed_chi2")
    _count("observed_chi2", lambda: paths.observed_chi2_work(obs_w, K, L))
    return out


def observed_update(W, dp, Hll_inv, b_l, points_w, obs_w, *, out=None):
    """``points_w - Hll_inv (b_l + W^T dp)``, ``[L, 3]``: the landmarks'
    step of the back-substitution, ``W^T dp`` summed over the slots where
    ``obs_w [K, L]`` is not 0 from the planes ``W [3, 6K, L]`` (row ``6k +
    q``) and the pose step ``dp [K, 6]``; ``Hll_inv [L, 3, 3]``, ``b_l [L,
    3]``. Into ``out`` (``[L, 3]``, not ``points_w``) where given."""
    if not W.is_cuda:
        got = observed_update_plain(W, dp, Hll_inv, b_l, points_w, obs_w)
        return got if out is None else out.copy_(got)
    K, L = obs_w.shape
    dev = W.device
    if (W.shape != (3, 6 * K, L) or dp.shape != (K, 6) or Hll_inv.shape != (L, 3, 3)
            or b_l.shape != (L, 3) or points_w.shape != (L, 3) or K < 1 or L < 1):
        raise ValueError(
            f"observed_update: shapes W {tuple(W.shape)}, dp {tuple(dp.shape)}, Hll_inv "
            f"{tuple(Hll_inv.shape)}, b_l {tuple(b_l.shape)}, points_w "
            f"{tuple(points_w.shape)}, obs_w {tuple(obs_w.shape)} do not form a [K, L] window")
    if out is None:
        out = torch.empty_like(points_w)
    _check("observed_update", dev, W=W, dp=dp, Hll_inv=Hll_inv, b_l=b_l, points_w=points_w,
           obs_w=obs_w, out=out)
    if out.shape != (L, 3) or out.data_ptr() == points_w.data_ptr():
        raise ValueError("observed_update: out must be an [L, 3] tensor apart from points_w")
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        err = lib.svi_observed_update(
            W.data_ptr(), dp.data_ptr(), Hll_inv.data_ptr(), b_l.data_ptr(),
            points_w.data_ptr(), obs_w.data_ptr(), out.data_ptr(), K, L,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "svi_observed_update")
    _count("observed_update", lambda: paths.observed_update_work(obs_w, K, L))
    return out
