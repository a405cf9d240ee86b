"""Photometric stressor layer over the synthetic renderer.

The reference validates accuracy by replaying *recorded* KITTI / VI-sensor
imagery (ref `src/runnable/tracker_gt.cpp:182-267`) — real sensors with
read noise, auto-exposure hunting, motion blur, blank walls, specular
surfaces and moving occluders. This module degrades the clean synthetic
renders with a sensor + scene model so that accuracy claims do not rest on
noise-free, perfectly photoconsistent images.

**World-level** stressors (coherent between the two views): low-texture
spans of world z (the blank-wall condition), a view-dependent specular
sheen, and untextured occluder panels fixed in the camera frame at physical
depths, drawn with the correct disparity in each view.

**Sensor-level** stressors (independent per view): additive Gaussian read
noise + 8-bit quantization, exposure gain and gamma drift out of phase
between the two cameras, horizontal motion blur, vignetting.

Everything is deterministic in (seed, frame index, view) and runs on the
camera's device. The read noise is the JAX package's stream: the counter-
based Threefry-2x32 generator behind ``jax.random`` (its partitionable
counter layout) is integer arithmetic, restated here on int64 tensors, so
``jax.random.normal(fold_in(PRNGKey(seed), 2 * frame + view))`` gets the
same bits here; the transform to normal deviates (uniform in (-1, 1), then
``sqrt(2) erfinv``) is the JAX package's, to the last bits of ``erfinv``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.io import synthetic as syn


@dataclasses.dataclass(frozen=True)
class StressParams:
    """Photometric stress configuration (frozen and hashable).

    All intensities are on the renderer's 0..255 scale.
    """

    # sensor
    noise_std: float = 0.0          # additive Gaussian read noise, DN
    gain_amp: float = 0.0           # exposure gain drift amplitude (x(1 +- amp))
    gain_period: float = 60.0       # frames per exposure-hunt cycle
    gamma_amp: float = 0.0          # gamma drift amplitude (gamma = 1 +- amp)
    gamma_period: float = 97.0
    blur_taps: int = 1              # horizontal box-blur length in px (1 = off)
    vignette: float = 0.0           # corner attenuation fraction (0..1)
    # world
    lowtex_spans: tuple[tuple[float, float], ...] = ()  # world-z intervals
    lowtex_strength: float = 0.0    # contrast kept = 1 - strength inside spans
    specular_amp: float = 0.0       # sheen amplitude as fraction of 255
    # occluders: (u_center_frac, v_center_frac, half_w_frac, half_h_frac,
    #             depth_m, drift_px_per_frame)
    occluders: tuple[tuple[float, float, float, float, float, float], ...] = ()
    occluder_intensity: float = 24.0
    seed: int = 0


# calibrated presets (the JAX package's; bounds in tests/test_stress.py)
MILD = StressParams(
    noise_std=2.0, gain_amp=0.06, gamma_amp=0.04, vignette=0.15,
)
MODERATE = StressParams(
    noise_std=4.0, gain_amp=0.12, gamma_amp=0.08, blur_taps=3, vignette=0.25,
    lowtex_spans=((60.0, 90.0),), lowtex_strength=0.75, specular_amp=0.12,
    occluders=((0.22, 0.72, 0.05, 0.08, 2.2, 0.0),),
)
SEVERE = StressParams(
    noise_std=8.0, gain_amp=0.25, gamma_amp=0.15, blur_taps=5, vignette=0.35,
    lowtex_spans=((50.0, 80.0), (130.0, 165.0)), lowtex_strength=0.9,
    specular_amp=0.25,
    occluders=(
        (0.20, 0.70, 0.06, 0.09, 2.2, 0.0),
        (0.80, 0.28, 0.05, 0.07, 3.0, 0.15),
    ),
)
PRESETS = {"clean": StressParams(), "mild": MILD, "moderate": MODERATE,
           "severe": SEVERE}

# fixed pseudo-reflection direction fields for the sheen term
_SPEC_KP = (0.9, 2.3, 0.31)
_SPEC_KO = (1.7, 0.4, 1.13)


# ---------------------------------------------------------------------------
# the JAX package's random stream: Threefry-2x32 on int64 tensors
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(key: tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under ``key``, as ``jax.random``'s ``threefry2x32`` primitive. The
    counters and results are uint32 values held in int64 tensors."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _MASK32, (x1 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**31)``."""
    return (0, int(seed) & _MASK32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)``."""
    a, b = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                        torch.tensor([int(data) & _MASK32], dtype=torch.int64))
    return int(a[0]), int(b[0])


def random_bits(key: tuple[int, int], shape: tuple, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` with the partitionable counter
    layout: element ``n`` of the row-major order hashes the pair
    ``(n >> 32, n & 0xFFFFFFFF)``, and its bits are the XOR of the two
    results. uint32 values in an int64 tensor."""
    n = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    a, b = threefry2x32(key, n >> 32, n & _MASK32)
    return (a ^ b).reshape(shape)


def normal(key: tuple[int, int], shape: tuple, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the top 23 bits as a float
    in [1, 2), mapped to [nextafter(-1, 0), 1), then ``sqrt(2) erfinv``."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = torch.clamp(floats * float(np.float32(1.0) - lo) + float(lo), min=float(lo))
    return float(np.float32(np.sqrt(2))) * torch.erfinv(u)


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def _lowtex_contrast(z: torch.Tensor, sp: StressParams) -> torch.Tensor:
    """Per-hit contrast multiplier from the low-texture world-z spans."""
    c = torch.ones_like(z)
    for (z0, z1) in sp.lowtex_spans:
        # smooth 2 m shoulders so the wall fades in like paint, not a seam
        inside = torch.sigmoid((z - z0) / 2.0) * torch.sigmoid((z1 - z) / 2.0)
        c = c * (1.0 - sp.lowtex_strength * inside)
    return c


def _dot3(v: torch.Tensor, k) -> torch.Tensor:
    """``v [..., 3] . k`` summed in the contraction's order."""
    return v[..., 0] * k[0] + v[..., 1] * k[1] + v[..., 2] * k[2]


def render_stressed_view(
    T_wc: torch.Tensor, fx: float, cx: float, cy: float,
    baseline_shift: float, frame_idx: int, view: int,
    sp: StressParams, width: int, height: int,
) -> torch.Tensor:
    """Render one view with world- and sensor-level stress applied, on
    ``T_wc``'s device. Scalars are rounded to float32 as the JAX package
    holds them."""
    f32 = np.float32
    dev = T_wc.device
    o, dir_w, best_t = syn.raycast(T_wc, fx, cx, cy, baseline_shift, width, height)
    hit_w = o[None, None, :] + best_t[..., None] * dir_w

    img = syn._texture(hit_w)
    # world-level: low-texture spans (contrast collapse around mid-gray)
    if sp.lowtex_spans and sp.lowtex_strength > 0.0:
        c = _lowtex_contrast(hit_w[..., 2], sp)
        img = 127.5 + (img - 127.5) * c
    # world-level: view-dependent specular sheen
    if sp.specular_amp > 0.0:
        kp = torch.tensor(_SPEC_KP, dtype=torch.float32, device=dev)
        ko = torch.tensor(_SPEC_KO, dtype=torch.float32, device=dev)
        h = torch.sin(_dot3(hit_w, kp) + _dot3(o, ko))
        sheen = torch.sigmoid(10.0 * (h - 0.6))
        img = img + float(f32(sp.specular_amp * 255.0)) * sheen
    img = torch.where(torch.isfinite(best_t), img, torch.zeros_like(img))

    f = f32(frame_idx)
    # occluders: camera-frame panels at depth, disparity-correct per view
    if sp.occluders:
        u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    for i, (ufc, vfc, hwf, hhf, depth, drift) in enumerate(sp.occluders):
        disp = f32(fx) * f32(baseline_shift) / f32(depth)
        u0 = f32(ufc * width) + f32(drift) * f * f32((i % 2) * 2 - 1) - disp
        v0 = f32(vfc * height)
        inside = ((torch.abs(u - float(u0)) <= float(f32(hwf * width)))
                  & (torch.abs(v - float(v0)) <= float(f32(hhf * height))))
        img = torch.where(inside, torch.full_like(img, float(f32(sp.occluder_intensity))),
                          img)

    # sensor-level: exposure gain + gamma drift (out of phase between views)
    phase = f32(2.1 * view)
    two_pi = f32(2.0 * np.pi)
    if sp.gain_amp > 0.0:
        gain = f32(1.0) + f32(sp.gain_amp) * np.sin(two_pi * f / f32(sp.gain_period) + phase)
        img = img * float(gain)
    if sp.gamma_amp > 0.0:
        gamma = f32(1.0) + f32(sp.gamma_amp) * np.sin(
            two_pi * f / f32(sp.gamma_period) + phase + f32(1.3))
        img = 255.0 * torch.pow(torch.clamp(img / 255.0, 0.0, 1.0), float(gamma))
    # horizontal motion blur (edge-replicated box filter)
    if sp.blur_taps > 1:
        k = sp.blur_taps
        padded = torch.cat([img[:, :1].expand(-1, k // 2), img,
                            img[:, -1:].expand(-1, k - 1 - k // 2)], dim=1)
        img = sum(padded[:, i:i + width] for i in range(k)) / k
    if sp.vignette > 0.0:
        uu = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] - width / 2) \
            / (width / 2)
        vv = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] - height / 2) \
            / (height / 2)
        img = img * (1.0 - float(f32(sp.vignette * 0.5)) * (uu * uu + vv * vv))
    if sp.noise_std > 0.0:
        key = fold_in(prng_key(sp.seed), frame_idx * 2 + view)
        img = img + float(f32(sp.noise_std)) * normal(key, tuple(img.shape), dev)
    # 8-bit sensor output
    return torch.clamp(torch.round(img), 0.0, 255.0)


def render_stressed_stereo(cam: StereoCamera, T_wc, frame_idx: int,
                           sp: StressParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The stressed (left, right) pair for a world->LEFT-camera pose, on the
    camera's device."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32).to(cam.device)
    fx = cam.left.fx
    imgL = render_stressed_view(T_wc, fx, cam.left.cx, cam.left.cy, 0.0,
                                frame_idx, 0, sp, cam.width, cam.height)
    imgR = render_stressed_view(T_wc, fx, cam.right.cx, cam.right.cy, cam.baseline,
                                frame_idx, 1, sp, cam.width, cam.height)
    return imgL, imgR


class StressedSequence(syn.SyntheticSequence):
    """``SyntheticSequence`` with the photometric stress model applied.

    Drop-in for ``SyntheticSequence`` (same ``cam`` / ``poses_wc`` /
    ``frame`` API, rendered in the corridor world); ``stress`` is a
    ``StressParams`` or a preset name from ``PRESETS`` ("clean" / "mild" /
    "moderate" / "severe"). ``device=None`` means CUDA.
    """

    def __init__(self, *args, stress: StressParams | str = "moderate", **kwargs):
        super().__init__(*args, **kwargs)
        self.stress = PRESETS[stress] if isinstance(stress, str) else stress

    def frame(self, i: int):
        imgL, imgR = render_stressed_stereo(self.cam, self.poses_wc[i], i, self.stress)
        return imgL, imgR, self.poses_wc[i]
