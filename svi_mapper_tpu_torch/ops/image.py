"""Image-plane ops: box and Gaussian blur, Sobel gradients, max filter,
histogram equalization, bilinear remap, and the host-side stereo
rectification that builds the remap tables (``cv::equalizeHist``,
CTrackerSVI.cpp:339-341; ``cv::remap`` / ``initUndistortRectifyMap`` /
``stereoRectify``, CStereoCamera.h:89-107, CStereoCameraIMU.h:20-52).

All ops take float32 single-channel images ``[H, W]``. Separable filters are
written as shift-multiply-accumulate over the (small, static) tap count,
in a fixed order — ``0 + tap0*k0`` first, then ``+ tap1*k1`` … — with the
multiply and the add rounded separately. The dense BRIEF field compares
blurred intensities, so the order of this sum decides descriptor bits; a
library convolution (which may reorder the sum or run in TF32 on the card)
is deliberately not used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
         mode: str, value: float = 0.0) -> torch.Tensor:
    x = img[None, None]
    if mode == "edge":
        x = F.pad(x, (left, right, top, bottom), mode="replicate")
    else:
        x = F.pad(x, (left, right, top, bottom), mode="constant", value=value)
    return x[0, 0]


def _conv1d(img: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable 1D convolution along an axis with SAME edge padding.

    ``kernel`` is a 1-D float32 tensor on any device or a list of floats;
    each tap multiplies as a float32 scalar.
    """
    taps = [float(t) for t in kernel]
    k = len(taps)
    pad = k // 2
    h, w = img.shape
    if axis == 0:
        padded = _pad(img, pad, pad, 0, 0, "edge")
    else:
        padded = _pad(img, 0, 0, pad, pad, "edge")
    out = torch.zeros_like(img)
    for i in range(k):
        tap = padded[i:i + h, :] if axis == 0 else padded[:, i:i + w]
        out = out + tap * taps[i]
    return out


def _maxpool_separable(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 max filter as two separable shifted-max passes."""
    h, w = img.shape

    def pass_axis(x, axis):
        if axis == 0:
            padded = _pad(x, radius, radius, 0, 0, "constant", float("-inf"))
        else:
            padded = _pad(x, 0, 0, radius, radius, "constant", float("-inf"))
        out = x
        for i in range(2 * radius + 1):
            if i == radius:
                continue
            tap = padded[i:i + h, :] if axis == 0 else padded[:, i:i + w]
            out = torch.maximum(out, tap)
        return out

    return pass_axis(pass_axis(img, 0), 1)


def _box_taps(size: int) -> list[float]:
    # the float32 value of 1/size, as the reference builds its kernel
    return [float(np.float32(1.0 / size))] * size


def box_blur(img: torch.Tensor, size: int = 9) -> torch.Tensor:
    """Separable box blur (the BRIEF smoothing window): rows axis first,
    then columns."""
    k = _box_taps(size)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y gradients (separable [1 2 1] x [-1 0 1])."""
    smooth = [1.0, 2.0, 1.0]
    diff = [-1.0, 0.0, 1.0]
    ix = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    iy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return ix, iy


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 4) -> torch.Tensor:
    k = _gaussian_kernel(sigma, radius)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def equalize_hist(img_u8: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of a uint8 image -> float32 in [0, 255]
    (``cv::equalizeHist``, used on every SVI frame, CTrackerSVI.cpp:339-341).

    A 256-bin histogram, its cumulative sum and a LUT gather, all on the
    image's device with no host read: the histogram is an integer
    ``scatter_add_`` (exact; ``torch.bincount`` would read the maximum on the
    host first). The LUT is ``((cdf - cdf_min) / (total - cdf_min)) * 255``
    in float32 in that order, clipped to [0, 255]."""
    flat = img_u8.reshape(-1).to(torch.int64)
    hist = torch.zeros(256, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    cdf = torch.cumsum(hist, 0)
    total = cdf[-1]
    # OpenCV convention: scale by (cdf - cdf_min) / (total - cdf_min) * 255
    cdf_min = torch.min(torch.where(hist > 0, cdf, total))
    denom = torch.clamp(total - cdf_min, min=1)
    lut = ((cdf - cdf_min).to(torch.float32) / denom.to(torch.float32)) * 255.0
    lut = torch.clamp(lut, 0.0, 255.0)
    return lut[flat].reshape(img_u8.shape)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """``clip(x, 0, 255)`` truncated to uint8, as the JAX package's
    ``jnp.clip(x, 0, 255).astype(uint8)``; NaN gives 0, as XLA's
    conversion gives it."""
    return torch.clamp(torch.nan_to_num(img.to(torch.float32), nan=0.0),
                       0.0, 255.0).to(torch.uint8)


def _floor_index(x0: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(int32(x0), 0, n - 1)`` with XLA's saturating float -> int
    conversion (NaN -> 0): clamped in float first, so the cast never sees a
    value outside int32 (PyTorch's cast of one is undefined)."""
    x0 = torch.nan_to_num(x0, nan=0.0)
    return torch.clamp(x0, 0.0, float(n - 1)).to(torch.int64)


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap: ``out[i, j] = img(map_y[i, j], map_x[i, j])``
    (``cv::remap`` for undistortion/rectification, CStereoCamera.h:89-107).
    Out-of-bounds samples clamp to the border. The blend keeps the JAX
    package's order, ``top * (1 - fy) + bot * fy``, each step rounded on
    its own."""
    h, w = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = _floor_index(x0, w)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = _floor_index(y0, h)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def undistort_rectify_maps(
    K: np.ndarray,
    dist: np.ndarray,
    R_rect: np.ndarray,
    P_new: np.ndarray,
    width: int,
    height: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute undistort+rectify sampling maps (host-side, float64).

    Equivalent of ``cv::initUndistortRectifyMap`` (CStereoCameraIMU.h:20-52):
    for each rectified output pixel, find the raw-image source coordinate by
    back-rotating through ``R_rect`` and applying the radial-tangential
    distortion model (k1, k2, p1, p2 — the reference's 4-coefficient model,
    vecDistortionCoefficients in hardware_parameters files).

    Returns (map_x, map_y) float32 arrays shaped [height, width] to feed
    :func:`remap_bilinear` on the device.
    """
    k1, k2, p1, p2 = [float(c) for c in np.asarray(dist).reshape(-1)[:4]]
    fx_n, fy_n = P_new[0, 0], P_new[1, 1]
    cx_n, cy_n = P_new[0, 2], P_new[1, 2]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # rectified pixel -> normalized rectified ray
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    # rotate back into the raw camera frame
    rays_raw = rays @ R_rect  # == R_rect.T applied to each ray (row-vector form)
    xr = rays_raw[..., 0] / rays_raw[..., 2]
    yr = rays_raw[..., 1] / rays_raw[..., 2]
    # distort
    r2 = xr * xr + yr * yr
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xr * radial + 2.0 * p1 * xr * yr + p2 * (r2 + 2.0 * xr * xr)
    yd = yr * radial + p1 * (r2 + 2.0 * yr * yr) + 2.0 * p2 * xr * yr
    # raw intrinsics
    map_x = K[0, 0] * xd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def stereo_rectify(
    K0: np.ndarray, dist0: np.ndarray,
    K1: np.ndarray, dist1: np.ndarray,
    T_10: np.ndarray,
    width: int, height: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compute rectifying rotations + new projections for a stereo pair
    (Bouguet's algorithm — the ``cv::stereoRectify`` used by the reference's
    IMU camera construction, CStereoCameraIMU.h:20-52 and
    CParameterBase.h:169-392). Host-side, float64.

    ``T_10`` maps cam0-frame points into cam1: ``x1 = R x0 + t``. Returns
    ``(R_rect0, R_rect1, P0, P1)`` with a shared rectified K (averaged
    focal/principal point) and ``P1[0,3] = fx * t_rect_x`` — negative when
    cam0 is the left camera, matching the ``P_R[0,3] = -fx b`` disparity
    convention (Types.h:48-51).
    """
    R = np.asarray(T_10[:3, :3], np.float64)
    t = np.asarray(T_10[:3, 3], np.float64)
    # split the relative rotation evenly between the two cameras:
    # R_rect0 = B exp(+om/2), R_rect1 = B exp(-om/2)  =>  R_rect1 R = R_rect0
    # rotation vector via log map
    cos_th = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-12:
        om = np.zeros(3)
    else:
        om = th / (2.0 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])

    def _exp(v):
        a = np.linalg.norm(v)
        if a < 1e-12:
            return np.eye(3)
        k = v / a
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)

    half_p = _exp(0.5 * om)
    half_m = _exp(-0.5 * om)
    t_half = half_m @ t                     # translation seen from the midframe
    # baseline-aligned common orientation: rows e1 (baseline), e2, e3.
    # e1 follows the sign of the dominant horizontal component so the
    # rectified x-axis keeps pointing right and a left-camera cam0 yields
    # t_rect_x = -baseline (cv::stereoRectify's uu-sign choice)
    sign = -1.0 if t_half[0] < 0 else 1.0
    e1 = sign * t_half / max(np.linalg.norm(t_half), 1e-12)
    nxy = np.hypot(e1[0], e1[1])
    if nxy < 1e-9:
        e2 = np.array([1.0, 0.0, 0.0])      # degenerate: baseline along z
    else:
        e2 = np.array([-e1[1], e1[0], 0.0]) / nxy
    e3 = np.cross(e1, e2)
    B = np.stack([e1, e2, e3])
    R_rect0 = B @ half_p
    R_rect1 = B @ half_m

    fx = 0.5 * (K0[0, 0] + K1[0, 0])
    fy = 0.5 * (K0[1, 1] + K1[1, 1])
    cx = 0.5 * (K0[0, 2] + K1[0, 2])
    cy = 0.5 * (K0[1, 2] + K1[1, 2])
    K_new = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    t_rect = R_rect1 @ t                    # == B @ t_half = [±|t|, 0, 0]
    P0 = np.hstack([K_new, np.zeros((3, 1))])
    P1 = np.hstack([K_new, np.zeros((3, 1))])
    P1[0, 3] = fx * t_rect[0]
    return R_rect0, R_rect1, P0, P1


def pad_to_multiple(img: torch.Tensor, multiple: int = 128) -> torch.Tensor:
    """Pad an image with zeros up to tile-aligned dimensions."""
    h, w = img.shape
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img
    return _pad(img, 0, ph, 0, pw, "constant", 0.0)
