"""Synthetic stereo sequence generator with exact ground truth (the
corridor world, and a ring world for large loops).

A deterministic multi-plane world with a procedural texture evaluated at the
3D hit point, so left/right images are exactly photoconsistent, ground-truth
poses and depths are exact, and sequences of any length are generated on the
fly with no data files. The world is a KITTI-like corridor (ground plane +
two walls + far wall, y-down camera convention); the texture is a fixed-seed
thresholded sum of sines over world coordinates. Texture parameters come
from numpy with the same seed as the JAX package's renderer, so both render
the same world (up to float32 rounding of the sine sum).
"""

from __future__ import annotations

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import (
    StereoCamera,
    pinhole_from_projection,
)
from svi_mapper_tpu_torch.utils.device import resolve_device


def default_camera(width: int = 512, height: int = 256, baseline: float = 0.54,
                   device: torch.device | str | None = None) -> StereoCamera:
    """A KITTI-like stereo camera at reduced resolution."""
    dev = resolve_device(device)
    fx = 718.856 * width / 1241.0
    cx, cy = width / 2.0, height / 2.0
    P_l = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]], np.float64)
    P_r = P_l.copy()
    P_r[0, 3] = -fx * baseline
    return StereoCamera(
        left=pinhole_from_projection(P_l, width, height, device=dev),
        right=pinhole_from_projection(P_r, width, height, device=dev),
    )


def _make_texture_params(seed: int = 5, n_waves: int = 48):
    rng = np.random.default_rng(seed)
    # log-uniform spatial frequencies, 0.3 .. 20 rad/m
    freq_mag = np.exp(rng.uniform(np.log(0.3), np.log(20.0), n_waves))
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    omega = dirs * freq_mag[:, None]
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    amp = rng.uniform(0.5, 1.0, n_waves) / np.sqrt(n_waves)
    return (omega.astype(np.float32), phase.astype(np.float32),
            amp.astype(np.float32))


_OMEGA, _PHASE, _AMP = _make_texture_params()

# planes: (point, normal, axis1, extent1, axis2, extent2)
# camera convention: x right, y DOWN, z forward. Ground at y=+1.5 (below).
_PLANES = [
    # ground
    ((0.0, 1.5, 0.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), 60.0, (0.0, 0.0, 1.0), 500.0),
    # left wall
    ((-9.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 4.0, (0.0, 0.0, 1.0), 500.0),
    # right wall
    ((9.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 4.0, (0.0, 0.0, 1.0), 500.0),
    # far wall (keeps the vanishing region textured)
    ((0.0, 0.0, 480.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0), 60.0, (0.0, 1.0, 0.0), 40.0),
]


def ring_world(radius: float, half_width: float = 9.0,
               n_segments: int = 16, wall_half_height: float = 4.0) -> tuple:
    """Plane world for LARGE circular loops: an annular circuit.

    The corridor world (``_PLANES``) is sized for small loops (walls at
    x = +-9, ground +-60 m); a loop of radius ~100 m leaves it. This builds a
    world that CONTAINS such a loop: a big ground plane plus inner/outer
    polygon fence walls (``n_segments`` planar segments each) bracketing the
    ring the camera drives, so every viewpoint on the loop sees textured
    ground ahead and depth-structured walls to both sides.

    ``loop_trajectory(n, radius)`` starts at the origin heading +z and
    curves toward +x, so its circle is centered at (radius, 0, 0) — the
    returned world is centered there too.
    """
    import math

    cx = float(radius)
    e_ground = radius + half_width + 30.0
    planes = [
        ((cx, 1.5, 0.0), (0.0, -1.0, 0.0),
         (1.0, 0.0, 0.0), e_ground, (0.0, 0.0, 1.0), e_ground),
    ]
    fences = [radius + half_width]
    if radius - half_width > 1.0:
        fences.append(radius - half_width)
    for r_f in fences:
        e1 = r_f * math.tan(math.pi / n_segments) + 0.5   # overlap corners
        for s in range(n_segments):
            phi = 2.0 * math.pi * s / n_segments
            c, sn = math.cos(phi), math.sin(phi)
            planes.append((
                (cx + r_f * c, 0.0, r_f * sn),
                (-c, 0.0, -sn),                 # sign irrelevant: raycast
                (-sn, 0.0, c), float(e1),       # has no backface culling
                (0.0, 1.0, 0.0), float(wall_half_height),
            ))
    return tuple(planes)


def _texture(p: torch.Tensor) -> torch.Tensor:
    """Procedural intensity at world points ``p`` [..., 3] (about 0..255): a
    mostly piecewise-constant "blob" field (thresholded sine sum) plus a
    smooth component — blob boundaries give strong, BRIEF-stable corners."""
    dev = p.device
    omega = torch.from_numpy(_OMEGA).to(dev)
    phases = torch.einsum("...i,ki->...k", p, omega) + torch.from_numpy(_PHASE).to(dev)
    val = torch.sum(torch.sin(phases) * torch.from_numpy(_AMP).to(dev), dim=-1)
    hard = (val > 0).to(torch.float32)
    soft = val * 0.5 + 0.5
    return (0.75 * hard + 0.25 * soft) * 255.0


def raycast(T_wc: torch.Tensor, fx: float, cx: float, cy: float,
            baseline_shift: float, width: int, height: int, planes=None):
    """Intersect the per-pixel view rays with the plane world.

    Returns ``(o, dir_w, best_t)``: camera center in world [3], world-frame
    ray directions [H, W, 3], and ray parameter of the first hit [H, W]
    (``inf`` where no plane is hit).
    """
    if planes is None:
        planes = _PLANES
    dev = T_wc.device
    f32 = torch.float32
    T_cw = se3.inv_T(T_wc)
    R_cw = T_cw[:3, :3]
    # camera center in world = T_cw @ [shift,0,0]
    o = T_cw[:3, 3] + R_cw[:, 0] * baseline_shift

    u = torch.arange(width, dtype=f32, device=dev)[None, :]
    v = torch.arange(height, dtype=f32, device=dev)[:, None]
    dir_cam = torch.stack(
        [
            ((u - cx) / fx).expand(height, width),
            ((v - cy) / fx).expand(height, width),
            torch.ones((height, width), dtype=f32, device=dev),
        ],
        dim=-1,
    )
    dir_w = torch.einsum("ij,hwj->hwi", R_cw, dir_cam)

    best_t = torch.full((height, width), float("inf"), dtype=f32, device=dev)
    for (p0, n, a1, e1, a2, e2) in planes:
        p0 = torch.tensor(p0, dtype=f32, device=dev)
        n = torch.tensor(n, dtype=f32, device=dev)
        a1 = torch.tensor(a1, dtype=f32, device=dev)
        a2 = torch.tensor(a2, dtype=f32, device=dev)
        denom = torch.einsum("hwi,i->hw", dir_w, n)
        t_num = torch.dot(p0, n) - torch.dot(o, n)
        t = t_num / torch.where(torch.abs(denom) < 1e-9,
                                torch.full_like(denom, 1e-9), denom)
        hit = o[None, None, :] + t[..., None] * dir_w
        d1 = torch.einsum("hwi,i->hw", hit - p0[None, None, :], a1)
        d2 = torch.einsum("hwi,i->hw", hit - p0[None, None, :], a2)
        ok = (t > 0.1) & (torch.abs(d1) <= e1) & (torch.abs(d2) <= e2)
        best_t = torch.where(ok & (t < best_t), t, best_t)
    return o, dir_w, best_t


def fold_mod(x: torch.Tensor, period: float) -> torch.Tensor:
    """``x`` modulo ``period`` with the sign of the period, as ``jnp.mod``
    computes it: the exact truncated remainder, shifted by one period where
    its sign differs from the period's."""
    r = torch.fmod(x, period)
    return torch.where((r != 0) & ((r < 0) != (period < 0)), r + period, r)


def render_view(T_wc: torch.Tensor, fx: float, cx: float, cy: float,
                baseline_shift: float, width: int, height: int,
                alias_period: float = 0.0, planes=None) -> torch.Tensor:
    """Render one camera view of the plane world. ``baseline_shift`` is the
    camera-center x-offset in the LEFT camera frame (0 for left, +baseline
    for right). With ``alias_period > 0`` the texture is evaluated on the
    world-z coordinate folded modulo the period: the corridor repeats the
    SAME visual motif every ``alias_period`` meters — geographically
    distinct places that look identical, the perceptual-aliasing attack a
    loop-closure pipeline's precision gates must survive."""
    o, dir_w, best_t = raycast(T_wc, fx, cx, cy, baseline_shift, width, height,
                               planes)
    hit_w = o[None, None, :] + best_t[..., None] * dir_w
    if alias_period > 0.0:
        hit_w = torch.cat([hit_w[..., :2], fold_mod(hit_w[..., 2:], alias_period)], -1)
    img = _texture(hit_w)
    return torch.where(torch.isfinite(best_t), img, torch.zeros_like(img))


def render_stereo(cam: StereoCamera, T_wc, alias_period: float = 0.0, planes=None):
    """Render the (left, right) pair for a world->LEFT-camera pose, on the
    camera's device."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32).to(cam.device)
    fx = cam.left.fx
    imgL = render_view(T_wc, fx, cam.left.cx, cam.left.cy, 0.0,
                       cam.width, cam.height, alias_period, planes)
    imgR = render_view(T_wc, fx, cam.right.cx, cam.right.cy, cam.baseline,
                       cam.width, cam.height, alias_period, planes)
    return imgL, imgR


def corridor_trajectory(n_frames: int, step: float = 0.8,
                        yaw_amp: float = 0.003) -> np.ndarray:
    """Ground-truth poses T_wc [N,4,4]: forward motion with gentle weaving
    (host-side, float32)."""
    poses = []
    T_cw = np.eye(4, dtype=np.float32)  # camera->world ("where am I")
    for i in range(n_frames):
        yaw = yaw_amp * np.sin(i * 0.15)
        d = se3.exp_se3(torch.tensor([0.0, 0.0, step, 0.0, yaw, 0.0],
                                     dtype=torch.float32)).numpy()
        T_cw = T_cw @ d
        poses.append(np.linalg.inv(T_cw).astype(np.float32))
    return np.stack(poses)


def loop_trajectory(n_frames: int, radius: float = 5.0,
                    frames_per_loop: int | None = None) -> np.ndarray:
    """Ground-truth poses T_wc [N,4,4] around a circle (camera heading
    tangent) — the loop-closure test trajectory. With
    ``frames_per_loop < n_frames`` the path continues past 2*pi, so late
    frames REVISIT early poses (closure opportunities at near-identical
    viewpoints)."""
    poses = []
    if frames_per_loop is None:
        frames_per_loop = n_frames
    step_angle = 2.0 * np.pi / frames_per_loop
    arc = radius * step_angle
    d = se3.exp_se3(torch.tensor([0.0, 0.0, arc, 0.0, step_angle, 0.0],
                                 dtype=torch.float32)).numpy()
    T_cw = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        T_cw = T_cw @ d
        poses.append(np.linalg.inv(T_cw).astype(np.float32))
    return np.stack(poses)


class SyntheticSequence:
    """Iterable stereo sequence with ground truth (the fixture generator).
    ``world`` is a plane tuple such as :func:`ring_world`; None means the
    corridor. ``alias_period > 0`` repeats the texture along world z (see
    :func:`render_view`)."""

    def __init__(self, n_frames: int = 40, width: int = 512, height: int = 256,
                 step: float = 0.8, yaw_amp: float = 0.003,
                 trajectory: str = "corridor", loop_radius: float = 5.0,
                 alias_period: float = 0.0, world: tuple | None = None,
                 device: torch.device | str | None = None):
        self.cam = default_camera(width, height, device=device)
        self.world = world
        if trajectory == "corridor":
            self.poses_wc = corridor_trajectory(n_frames, step, yaw_amp)
        elif trajectory == "loop":
            self.poses_wc = loop_trajectory(
                n_frames, loop_radius, frames_per_loop=int(n_frames / 1.15))
        else:
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.n_frames = n_frames
        self.alias_period = alias_period

    def frame(self, i: int):
        imgL, imgR = render_stereo(self.cam, self.poses_wc[i], self.alias_period,
                                   self.world)
        return imgL, imgR, self.poses_wc[i]

    def __iter__(self):
        for i in range(self.n_frames):
            yield self.frame(i)
