"""BA window preparation on the device: depth gating, re-init, tier weights.

Three stages, all masked lattice operations over the ``[K, L]`` window:

  * **depth-consistency gate** (ref 0.75 < |p_est|^2/|p_meas|^2 < 1.25,
    Cg2oOptimizer.cpp:1403-1410): an observation whose stereo-triangulated
    range disagrees with the current estimate by >25% never enters BA,
    with a 1 px pixel-space tolerance floor for far landmarks whose
    sub-pixel disparity noise breaks the relative band (the reference's
    disparity tier likewise bottoms out at 1 px, :1444-1447).
  * **self-consistency re-init**: when a landmark's measurements agree
    with EACH OTHER but not with its estimate, the estimate is re-seeded
    from the measurement back-projections (the reference gets this free —
    its vertex estimates start FROM the measured points, :1383-1401).
  * **depth-tiered information** (ref dInformationFactor = 1/z common to
    all three edge tiers, :1403; far landmarks need > 1 px of disparity,
    :1444-1447): per-observation weights 1/max(z, 1), mean-normalized over
    the window so the robust kernel's px^2 scale stays calibrated.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BAWindowPrep:
    mask: torch.Tensor       # [K,L] bool — post-gate observation mask
    X0: torch.Tensor         # [L,3] — (possibly re-seeded) landmark initializer
    obs_w: torch.Tensor      # [K,L] — per-observation information scale
    n_gated: torch.Tensor    # int32 — observations removed by the depth gate
    n_reinit: torch.Tensor   # int32 — landmarks re-seeded from measurements
    n_obs: torch.Tensor      # int32 — surviving observation count


def prepare_ba_window(
    T0: torch.Tensor,        # [K,4,4] keyframe poses (world->camera)
    obs: torch.Tensor,       # [K,L,4] stereo observations [uL,vL,uR,vR]
    mask: torch.Tensor,      # [K,L] bool
    X0: torch.Tensor,        # [L,3] current landmark estimates (world)
    cam: StereoCamera,
    *,
    far_d2: float = 50.0,          # squared range of the far tier
    min_far_disparity: float = 1.0,
    depth_weighting: bool = True,
    device=None,
) -> BAWindowPrep:
    """``device=None`` means CUDA (raises without one). No host read."""
    dev = resolve_device(device)
    T0, obs, mask, X0 = (torch.as_tensor(t, device=dev) for t in (T0, obs, mask, X0))
    fxl, fyl = cam.left.fx, cam.left.fy
    cxl, cyl = cam.left.cx, cam.left.cy
    bq = cam.right.p03
    dtype = X0.dtype
    R0 = T0[:, :3, :3]
    t0 = T0[:, None, :3, 3]

    disp = obs[..., 0] - obs[..., 2]                          # [K,L]
    inf = torch.full_like(disp, float("inf"))
    z_meas = torch.where(disp > 0.01, -bq / torch.clamp(disp, min=0.01), inf)
    x_meas = (obs[..., 0] - cxl) * z_meas / fxl
    y_meas = (obs[..., 1] - cyl) * z_meas / fyl
    d2_meas = x_meas ** 2 + y_meas ** 2 + z_meas ** 2
    m0 = mask & torch.isfinite(d2_meas)

    def gate(X):
        p_est = torch.einsum("kij,lj->kli", R0, X) + t0
        rel = torch.sum(p_est ** 2, dim=-1) / d2_meas
        band = torch.isfinite(rel) & (rel > 0.75) & (rel < 1.25)
        # pixel-space tolerance floor (see module docstring)
        d_pred = -bq / torch.clamp(p_est[..., 2], min=1e-3)
        return band | (torch.abs(disp - d_pred) <= 1.0)

    n_obs_l = torch.clamp(torch.sum(m0, dim=0), min=1)        # [L]
    consistent = gate(X0)
    bad_frac = torch.sum(m0 & ~consistent, dim=0) / n_obs_l

    # measurement self-consistency: back-projected world points of one
    # landmark must cluster relative to the measured range
    p_meas = torch.stack([x_meas, y_meas, z_meas], dim=-1)    # [K,L,3]
    m0f = m0.to(dtype)
    p_w = torch.einsum(
        "kji,klj->kli", R0,
        torch.where(m0[..., None], p_meas, torch.zeros_like(p_meas)) - t0)
    mean_w = torch.sum(p_w * m0f[..., None], dim=0) / n_obs_l[:, None]
    spread2 = torch.sum(torch.sum((p_w - mean_w) ** 2, dim=-1) * m0f, dim=0) / n_obs_l
    rbar = torch.sum(
        torch.sqrt(torch.where(m0, d2_meas, torch.zeros_like(d2_meas))), dim=0) / n_obs_l
    self_ok = (torch.sum(m0, dim=0) >= 2) & (torch.sqrt(spread2) < 0.25 * rbar)
    reinit = self_ok & (bad_frac > 0.5)
    X0_new = torch.where(reinit[:, None], mean_w, X0)
    consistent = gate(X0_new)

    # far landmarks with sub-threshold disparity never constrain (ref
    # 1.0 < dDisparity requirement of the disparity tier, :1444-1447)
    far_drop = (d2_meas >= far_d2) & (disp <= min_far_disparity)

    n_gated = torch.sum(mask & ~consistent).to(torch.int32)
    mask_new = mask & consistent & ~far_drop
    # a landmark reduced below two observations no longer constrains
    mask_new = mask_new & (torch.sum(mask_new, dim=0) >= 2)[None, :]

    if depth_weighting:
        zero = torch.zeros_like(z_meas)
        w = torch.where(m0, 1.0 / torch.clamp(z_meas, 1.0, 1e4), zero)
        mean_w_obs = (torch.sum(torch.where(mask_new, w, zero))
                      / torch.clamp(torch.sum(mask_new), min=1))
        obs_w = torch.where(mask_new, w / torch.clamp(mean_w_obs, min=1e-9), zero)
    else:
        obs_w = mask_new.to(dtype)

    return BAWindowPrep(
        mask=mask_new, X0=X0_new, obs_w=obs_w,
        n_gated=n_gated,
        n_reinit=torch.sum(reinit).to(torch.int32),
        n_obs=torch.sum(mask_new).to(torch.int32),
    )
