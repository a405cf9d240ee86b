"""The generator of whole maps: the inputs of a whole-map bundle adjustment
of one drive that closes on itself, made on the device from the seed.

The drive is one circuit of ``keyframes`` keyframes ``keyframe_spacing_m``
apart (the configuration's ``map`` group): the heading turns by 2 pi over
the drive plus a random walk of ``yaw_step_sd_rad`` per keyframe, tied so
that it ends where it started, and the centres are shifted along the drive
so that the keyframe after the last would be the first. So the last
keyframes see the first keyframes' landmarks: the loop closes.

``landmarks`` landmarks, in insertion order (by the keyframe that made
them, as a map table holds them), each drawn in the camera box of its
keyframe (``landmark_box_m``, x right, y down, z ahead) and observed by
every keyframe it projects into (inside the image, at a depth in
``visible_depth_m``). They are made in blocks of ``BLOCK`` landmarks, so
that the float64 transients stay a few hundred MB whatever the map's size.
The observations are the exact stereo projections plus ``pixel_noise_sd``
of noise per coordinate; the solve starts from landmarks off by
``landmark_init_sd_m`` and poses off by ``pose_init_sd_m`` /
``pose_init_sd_rad`` (the first ``fixed_poses`` exact and held), and the
pose chain is measured on the starting poses at weight ``chain_weight / (1
+ |t|^2)``, as in ``portbench.segments`` (those numbers come from the
traffic file).

Every draw comes from one ``torch.Generator`` seeded with ``--seed``, in
a fixed order, so the same seed and device give the same maps.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.lm_ba import Problem, exp_se3, inv_T, make_T
from portbench.segments import _rot_y, camera_numbers

BLOCK = 8192


def path(m: dict, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The true circuit: camera-to-world rotations ``[K, 3, 3]`` and camera
    centres ``[K, 3]``, float64."""
    f64 = dict(dtype=torch.float64, device=device)
    K = int(m["keyframes"])
    k = torch.arange(K, **f64)
    walk = torch.cumsum(torch.randn(K, generator=gen, **f64) * m["yaw_step_sd_rad"], 0)
    walk = walk - walk[0] - (k / K) * (walk[-1] - walk[0])          # tied at both ends
    R_wc = _rot_y(2 * math.pi * k / K + walk)
    fwd = R_wc[:, :, 2] * m["keyframe_spacing_m"]
    centre = torch.cumsum(fwd, 0) - fwd
    centre = centre - (k / K)[:, None] * fwd.sum(0)                 # the circuit closes
    return R_wc, centre


def make_map(traffic: dict, config: dict, gen: torch.Generator, device) -> Problem:
    """One whole map, float32 inputs (the mask bool) on ``device``."""
    device = torch.device(device)
    f64 = dict(dtype=torch.float64, device=device)
    m = config["map"]
    K, L = int(m["keyframes"]), int(m["landmarks"])
    cam = camera_numbers(config)

    R_wc, centre = path(m, gen, device)
    R_cw = R_wc.transpose(1, 2)
    T_true = make_T(R_cw, -(R_cw @ centre[:, :, None])[..., 0])

    # landmarks in the box of the keyframe that made them, in its order
    k0 = torch.sort(torch.randint(0, K, (L,), generator=gen, device=device)).values
    box = [m["landmark_box_m"][a] for a in "xyz"]
    lo = torch.tensor([b[0] for b in box], **f64)
    hi = torch.tensor([b[1] for b in box], **f64)
    local = lo + (hi - lo) * torch.rand(L, 3, generator=gen, **f64)
    X_true = torch.einsum("lij,lj->li", R_wc[k0], local) + centre[k0]

    # every keyframe that sees a landmark observes it, a block at a time
    obs = torch.zeros(K, L, 4, dtype=torch.float32, device=device)
    mask = torch.zeros(K, L, dtype=torch.bool, device=device)
    zmin, zmax = m["visible_depth_m"]
    for s in range(0, L, BLOCK):
        X = X_true[s: s + BLOCK]
        pc = torch.einsum("kij,lj->kli", T_true[:, :3, :3], X) + T_true[:, None, :3, 3]
        x, y, z = pc.unbind(-1)
        zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        ul = cam["fx"] * x / zs + cam["cx"]
        vl = cam["fy"] * y / zs + cam["cy"]
        ur = (cam["fx"] * x + cam["bq"]) / zs + cam["cx"]
        seen = ((z > zmin) & (z <= zmax) & (ul >= 0) & (ul < cam["width"])
                & (vl >= 0) & (vl < cam["height"]))
        noise = torch.randn(K, X.shape[0], 4, generator=gen, **f64) * traffic["pixel_noise_sd"]
        uv = (torch.stack([ul, vl, ur, vl], -1) + noise).to(torch.float32)
        obs[:, s: s + BLOCK] = torch.where(seen[..., None], uv, torch.zeros_like(uv))
        mask[:, s: s + BLOCK] = seen
        del pc, x, y, z, zs, ul, vl, ur, noise, uv

    # the start: landmarks and free poses off their true values
    X0 = X_true + torch.randn(L, 3, generator=gen, **f64) * traffic["landmark_init_sd_m"]
    nfix = int(traffic["fixed_poses"])
    xi = torch.randn(K, 6, generator=gen, **f64)
    xi[:, :3] *= traffic["pose_init_sd_m"]
    xi[:, 3:] *= traffic["pose_init_sd_rad"]
    xi[:nfix] = 0
    T0 = (exp_se3(xi) @ T_true).to(torch.float32)
    fix = torch.zeros(K, dtype=torch.bool, device=device)
    fix[:nfix] = True

    # the pose chain, measured on the starting poses
    T0d = T0.to(torch.float64)
    D = T0d[1:] @ inv_T(T0d[:-1])
    odo_M = torch.eye(4, **f64).repeat(K, 1, 1)
    odo_M[: K - 1] = D
    odo_w = torch.zeros(K, **f64)
    odo_w[: K - 1] = traffic["chain_weight"] / (1 + (D[:, :3, 3] ** 2).sum(-1))

    return Problem(T=T0, X=X0.to(torch.float32), obs=obs, mask=mask, fix=fix,
                   odo_M=odo_M.to(torch.float32), odo_w=odo_w.to(torch.float32))


def make_ring(traffic: dict, config: dict, seed: int, device) -> list[Problem]:
    """``traffic["ring"]`` maps from one generator seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return [make_map(traffic, config, gen, device) for _ in range(int(traffic["ring"]))]
