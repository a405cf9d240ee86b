"""The generator of map segments: the inputs of a map-segment bundle
adjustment, made on the device from the seed.

A segment is a window of ``keyframes`` keyframes along a forward path
(``keyframe_spacing_m`` apart, the heading a random walk of
``yaw_step_sd_rad`` per keyframe) and ``landmarks`` landmarks, each drawn
in the camera box of a random keyframe (``landmark_box_m``, x right, y
down, z ahead) and observed by every keyframe it projects into: inside the
image, at a depth in ``visible_depth_m``. The observations are the exact
stereo projections plus ``pixel_noise_sd`` of noise per coordinate; the
solve starts from landmarks off by ``landmark_init_sd_m`` and from poses
off by ``pose_init_sd_m`` / ``pose_init_sd_rad`` (the first
``fixed_poses`` exact and held). The pose chain is measured on the
starting poses, weight ``chain_weight / (1 + |t|^2)``, as the back-end
anchors its window to the keyframe chain it has. A configuration with a
``gravity`` group adds one measured down direction per keyframe: the true
one, as an accelerometer reads it with ``accel_noise_mps2`` of noise per
axis, normalised.

The numbers come from the traffic file and the configuration file; every
draw comes from one ``torch.Generator`` seeded with ``--seed``, in a few
large calls, so the same seed and device give the same segments.
"""

from __future__ import annotations

import torch

from portbench.reference.lm_ba import Problem, exp_se3, inv_T, make_T


def camera_numbers(config: dict) -> dict:
    """fx, fy, cx, cy, bq, width, height from the configuration's
    projection matrices, as float32 values (what both sides are given)."""
    cam = config["camera"]
    Pl = torch.tensor(cam["left_projection"], dtype=torch.float32)
    Pr = torch.tensor(cam["right_projection"], dtype=torch.float32)
    return dict(fx=float(Pl[0, 0]), fy=float(Pl[1, 1]), cx=float(Pl[0, 2]),
                cy=float(Pl[1, 2]), bq=float(Pr[0, 3]), width=int(cam["width"]),
                height=int(cam["height"]))


def _rot_y(yaw: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotations about the world's vertical (y) axis."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    o, z = torch.ones_like(yaw), torch.zeros_like(yaw)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def make_segment(traffic: dict, config: dict, gen: torch.Generator,
                 device: torch.device) -> Problem:
    """One segment, float32 inputs (the mask bool) on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    K, L = int(traffic["keyframes"]), int(traffic["landmarks"])
    cam = camera_numbers(config)

    # the true path: camera centres and camera-to-world rotations
    dyaw = torch.randn(K, generator=gen, **f64) * traffic["yaw_step_sd_rad"]
    dyaw[0] = 0
    yaw = torch.cumsum(dyaw, 0)
    R_wc = _rot_y(yaw)
    fwd = R_wc[:, :, 2] * traffic["keyframe_spacing_m"]
    centre = torch.cumsum(fwd, 0) - fwd[0]
    R_cw = R_wc.transpose(1, 2)
    T_true = make_T(R_cw, -(R_cw @ centre[:, :, None])[..., 0])

    # landmarks in the box of a random keyframe
    k0 = torch.randint(0, K, (L,), generator=gen, device=device)
    box = [traffic["landmark_box_m"][a] for a in "xyz"]
    lo = torch.tensor([b[0] for b in box], **f64)
    hi = torch.tensor([b[1] for b in box], **f64)
    local = lo + (hi - lo) * torch.rand(L, 3, generator=gen, **f64)
    X_true = torch.einsum("lij,lj->li", R_wc[k0], local) + centre[k0]

    # every keyframe that sees a landmark observes it
    pc = torch.einsum("kij,lj->kli", T_true[:, :3, :3], X_true) + T_true[:, None, :3, 3]
    x, y, z = pc.unbind(-1)
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    ul = cam["fx"] * x / zs + cam["cx"]
    vl = cam["fy"] * y / zs + cam["cy"]
    ur = (cam["fx"] * x + cam["bq"]) / zs + cam["cx"]
    zmin, zmax = traffic["visible_depth_m"]
    mask = ((z > zmin) & (z <= zmax) & (ul >= 0) & (ul < cam["width"])
            & (vl >= 0) & (vl < cam["height"]))
    noise = torch.randn(K, L, 4, generator=gen, **f64) * traffic["pixel_noise_sd"]
    obs = (torch.stack([ul, vl, ur, vl], -1) + noise).to(torch.float32)
    obs = torch.where(mask[..., None], obs, torch.zeros_like(obs))

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

    grav_d = grav_w = None
    g = config.get("gravity")
    if g:
        down = torch.tensor([0.0, -1.0, 0.0], **f64)
        acc = g["gravity_mps2"] * (T_true[:, :3, :3] @ down)
        acc = acc + torch.randn(K, 3, generator=gen, **f64) * g["accel_noise_mps2"]
        grav_d = (acc / acc.norm(dim=-1, keepdim=True)).to(torch.float32)
        grav_w = torch.full((K,), float(g["weight"]), dtype=torch.float32, device=device)

    return Problem(T=T0, X=X0.to(torch.float32), obs=obs, mask=mask, fix=fix,
                   odo_M=odo_M.to(torch.float32), odo_w=odo_w.to(torch.float32),
                   grav_d=grav_d, grav_w=grav_w)


def make_ring(traffic: dict, config: dict, seed: int, device) -> list[Problem]:
    """``traffic["ring"]`` segments from one generator seeded with
    ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return [make_segment(traffic, config, gen, device) for _ in range(int(traffic["ring"]))]
