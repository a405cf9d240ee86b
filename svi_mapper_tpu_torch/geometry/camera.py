"""Pinhole / stereo camera models as dataclasses of torch tensors.

Replaces ``CPinholeCamera`` (CPinholeCamera.h:11) and ``CStereoCamera``
(CStereoCamera.h:9). A camera is an immutable dataclass: the calibration
matrices are tensors on an explicit device, and the rectified intrinsics
(``fx, fy, cx, cy``, the right camera's ``P[0,3]``) are additionally cached
as Python floats holding the exact float32 values — so the per-frame
projection math multiplies by scalars and never reads the device. All
projection helpers are batched over leading point dimensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.utils.device import resolve_device

# Field-of-view safety inset in pixels used for in-view tests
# (ref CPinholeCamera.h:59-61: rectangle inset by 28 px).
FOV_INSET_PX = 28.0


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Rectified pinhole camera (ref CPinholeCamera.h:11).

    ``P`` is the 3x4 rectified projection matrix; for a rectified pair the
    right camera has ``P[0, 3] = -fx * baseline``. ``K``/``R_rect``/``dist``
    keep the raw calibration for un-rectified sources.
    """

    P: torch.Tensor          # (3, 4) rectified projection
    K: torch.Tensor          # (3, 3) raw intrinsics
    dist: torch.Tensor       # (4,) distortion coefficients (k1 k2 p1 p2)
    R_rect: torch.Tensor     # (3, 3) rectification rotation
    width: int = 0
    height: int = 0
    # values of P (in P's dtype) as Python floats (filled from P when left None)
    fx: float = None
    fy: float = None
    cx: float = None
    cy: float = None
    p03: float = None        # P[0, 3]

    def __post_init__(self):
        if self.fx is None:
            P = self.P.detach().cpu().numpy()
            for name, val in (("fx", P[0, 0]), ("fy", P[1, 1]),
                              ("cx", P[0, 2]), ("cy", P[1, 2]),
                              ("p03", P[0, 3])):
                object.__setattr__(self, name, float(val))

    @property
    def device(self) -> torch.device:
        return self.P.device

    # --- projections --------------------------------------------------------
    def project(self, p_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points -> pixel coordinates (u, v).

        Homogeneous-divide projection with the rectified ``P``. Points
        behind the camera produce garbage UVs — callers mask on
        ``p_cam[..., 2] > 0``.
        """
        ph = torch.cat([p_cam, torch.ones_like(p_cam[..., :1])], dim=-1)
        uvw = torch.einsum("ij,...j->...i", self.P, ph)
        z = uvw[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        return uvw[..., :2] / safe_z[..., None]

    def back_project(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels + depth -> camera-frame 3D points (rectified model)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def normalize(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> normalized image coordinates (z = 1 plane)."""
        return torch.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            dim=-1,
        )

    def in_fov(self, uv: torch.Tensor, inset: float = FOV_INSET_PX) -> torch.Tensor:
        """Inside the inset visibility rectangle (ref CPinholeCamera.h:59-61)."""
        return (
            (uv[..., 0] >= inset)
            & (uv[..., 0] <= self.width - 1 - inset)
            & (uv[..., 1] >= inset)
            & (uv[..., 1] <= self.height - 1 - inset)
        )

    def principal_weight(self, uv: torch.Tensor) -> torch.Tensor:
        """Distance-from-principal-point search-window weights (u, v):
        ``sqrt(|u - c|) / 10`` (ref CPinholeCamera.h:220-227)."""
        du = torch.sqrt(torch.abs(uv[..., 0] - self.cx)) / 10.0
        dv = torch.sqrt(torch.abs(uv[..., 1] - self.cy)) / 10.0
        return torch.stack([du, dv], dim=-1)


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Rectified stereo pair (ref CStereoCamera.h:9).

    ``baseline`` is positive; the right projection encodes
    ``P_R[0, 3] = -fx * baseline`` so that ``u_L - u_R = fx * baseline / z``.
    """

    left: PinholeCamera
    right: PinholeCamera

    @property
    def device(self) -> torch.device:
        return self.left.device

    @property
    def baseline(self) -> float:
        """Float32 quotient ``-P_R[0,3] / P_R[0,0]`` as a Python float."""
        return float(np.float32(-self.right.p03) / np.float32(self.right.fx))

    @property
    def width(self) -> int:
        return self.left.width

    @property
    def height(self) -> int:
        return self.left.height

    def depth_from_disparity(self, disparity: torch.Tensor) -> torch.Tensor:
        """z = fx * b / d (ref CTriangulator.cpp:326-356)."""
        safe_d = torch.clamp(disparity, min=1e-6)
        return -self.right.p03 / safe_d

    def disparity_from_depth(self, depth: torch.Tensor) -> torch.Tensor:
        safe_z = torch.clamp(depth, min=1e-6)
        return -self.right.p03 / safe_z

    def project_stereo(self, p_cam: torch.Tensor):
        """3D camera-frame points -> (uv_left, uv_right)."""
        return self.left.project(p_cam), self.right.project(p_cam)

    def triangulate(self, uv_left: torch.Tensor, uv_right: torch.Tensor) -> torch.Tensor:
        """Rectified linear triangulation from a left/right correspondence:
        depth from the u disparity, lateral coordinates from the left ray,
        v coordinates averaged (ref CTriangulator.cpp:326-356)."""
        disparity = uv_left[..., 0] - uv_right[..., 0]
        z = self.depth_from_disparity(disparity)
        v = 0.5 * (uv_left[..., 1] + uv_right[..., 1])
        x = (uv_left[..., 0] - self.left.cx) / self.left.fx * z
        y = (v - self.left.cy) / self.left.fy * z
        return torch.stack([x, y, z], dim=-1)


def torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch floating dtype (``np.float32``, ``"float64"``,
    ``torch.float32`` ...) as the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def pinhole_from_projection(
    P, width: int, height: int, K=None, dist=None, R_rect=None,
    dtype=np.float32, device: torch.device | str | None = None,
) -> PinholeCamera:
    """Build a camera from a 3x4 projection matrix (KITTI-style
    calibration, the ``matProjection`` line of the calibration files).
    ``dtype`` (numpy or torch) is the matrices' dtype, float32 by default;
    the cached ``fx, fy, cx, cy, p03`` hold the values in that dtype."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    np_dt = torch.zeros(0, dtype=dt).numpy().dtype

    def t(a, shape):
        a = np.asarray(a, dtype=np.float64).astype(np_dt).reshape(-1)
        return torch.from_numpy(a[: int(np.prod(shape))].reshape(shape).copy()).to(device)

    P_t = t(P, (3, 4))
    return PinholeCamera(
        P=P_t,
        K=P_t[:, :3].clone() if K is None else t(K, (3, 3)),
        dist=torch.zeros(4, dtype=dt, device=device)
        if dist is None else t(dist, (4,)),
        R_rect=torch.eye(3, dtype=dt, device=device)
        if R_rect is None else t(R_rect, (3, 3)),
        width=int(width),
        height=int(height),
    )
