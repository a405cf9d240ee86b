"""The port's ``geometry/triangulation.py`` and the camera builders'
``dtype=`` against the JAX package (mirrors the triangulation tests of
``tests/test_camera.py``).

Both packages solve the DLT by 3x3 normal equations in float32, summed in
another order. The normal equations square the system's condition (pixel
coordinates times projection rows, entries ~1e6), so the two solves agree
to 1e-3 relative (found: 2.1e-4), both within 5e-3 of the true points. The
essential and fundamental matrices and the epipolar lines, a few products
of small matrices, agree to 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu import config as jconfig
from svi_mapper_tpu.geometry import triangulation as jtri
from svi_mapper_tpu.geometry.camera import StereoCamera as JStereo
from svi_mapper_tpu.geometry.camera import pinhole_from_projection as jpinhole
from svi_mapper_tpu_torch import config
from svi_mapper_tpu_torch.geometry import triangulation as tri
from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

from torch_parity import t32

CPU = "cpu"
P_KITTI_L = np.array([[718.856, 0.0, 607.1928, 0.0],
                      [0.0, 718.856, 185.2157, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])
P_KITTI_R = np.array([[718.856, 0.0, 607.1928, -386.1448],
                      [0.0, 718.856, 185.2157, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])


def _cams():
    t = StereoCamera(left=pinhole_from_projection(P_KITTI_L, 1241, 376, device=CPU),
                     right=pinhole_from_projection(P_KITTI_R, 1241, 376, device=CPU))
    j = JStereo(left=jpinhole(P_KITTI_L, 1241, 376), right=jpinhole(P_KITTI_R, 1241, 376))
    return t, j


def _points(rng, n, zlo=2.0, zhi=50.0):
    return np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                     rng.uniform(zlo, zhi, n)], axis=-1).astype(np.float32)


def test_triangulate_dlt_roundtrip_and_parity(rng):
    cam, jcam = _cams()
    p = _points(rng, 128)
    uv_l, uv_r = (a.numpy() for a in cam.project_stereo(t32(p)))
    P_l = np.broadcast_to(P_KITTI_L.astype(np.float32), (128, 3, 4))
    P_r = np.broadcast_to(P_KITTI_R.astype(np.float32), (128, 3, 4))
    got = tri.triangulate_dlt(t32(P_l), t32(P_r), t32(uv_l), t32(uv_r)).numpy()
    want = np.asarray(jtri.triangulate_dlt(jnp.asarray(P_l), jnp.asarray(P_r),
                                           jnp.asarray(uv_l), jnp.asarray(uv_r)))
    assert got.shape == (128, 3) and got.dtype == np.float32
    assert np.allclose(got, p, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # one shared pair of projections broadcasts over the points
    one = tri.triangulate_dlt(t32(P_KITTI_L), t32(P_KITTI_R), t32(uv_l), t32(uv_r)).numpy()
    np.testing.assert_allclose(one, got, rtol=1e-5, atol=1e-5)


def test_epipolar_distance_zero_for_true_matches(rng):
    cam, jcam = _cams()
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -cam.baseline
    K_l, K_r = P_KITTI_L[:, :3].astype(np.float32), P_KITTI_R[:, :3].astype(np.float32)
    F = tri.fundamental_from_relative(t32(T_lr), t32(K_l), t32(K_r))
    jF = jtri.fundamental_from_relative(jnp.asarray(T_lr), jnp.asarray(K_l), jnp.asarray(K_r))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-5, atol=1e-9)
    p = _points(rng, 64)
    uv_l, uv_r = cam.project_stereo(t32(p))
    d = tri.epipolar_distance(F.expand(64, 3, 3), uv_l, uv_r).numpy()
    assert np.all(d < 1e-2)
    jd = np.asarray(jtri.epipolar_distance(jnp.broadcast_to(jF, (64, 3, 3)),
                                           jnp.asarray(uv_l.numpy()), jnp.asarray(uv_r.numpy())))
    np.testing.assert_allclose(d, jd, rtol=1e-3, atol=1e-4)


def test_essential_and_lines_against_jax(rng):
    """A general relative pose: E, F, lines and distances of unrelated
    points against the JAX functions."""
    from svi_mapper_tpu_torch.geometry import se3

    xi = rng.normal(0, 0.2, (5, 6)).astype(np.float32)
    T = se3.exp_se3(t32(xi))
    E = tri.essential_from_relative(T).numpy()
    jE = np.asarray(jtri.essential_from_relative(jnp.asarray(T.numpy())))
    np.testing.assert_allclose(E, jE, rtol=1e-5, atol=1e-6)
    K = P_KITTI_L[:, :3].astype(np.float32)
    F = tri.fundamental_from_relative(T, t32(K), t32(K))
    jF = jtri.fundamental_from_relative(jnp.asarray(T.numpy()), jnp.asarray(K), jnp.asarray(K))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-4, atol=1e-10)
    uv_a = rng.uniform(0, 1000, (5, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 1000, (5, 2)).astype(np.float32)
    line = tri.epipolar_line(F, t32(uv_a)).numpy()
    np.testing.assert_allclose(line, np.asarray(jtri.epipolar_line(jF, jnp.asarray(uv_a))),
                               rtol=1e-4, atol=1e-7)
    d = tri.epipolar_distance(F, t32(uv_a), t32(uv_b)).numpy()
    jd = np.asarray(jtri.epipolar_distance(jF, jnp.asarray(uv_a), jnp.asarray(uv_b)))
    np.testing.assert_allclose(d, jd, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, torch.float64, "float64"])
def test_camera_dtype(dtype):
    """``dtype=`` accepts a numpy or torch dtype; float32 by default."""
    cam = config.load_stereo_camera("kitti_00_camera_left.txt", "kitti_00_camera_right.txt",
                                    dtype=dtype, device=CPU)
    want = torch.float32 if dtype is np.float32 else torch.float64
    for c in (cam.left, cam.right):
        for f in ("P", "K", "dist", "R_rect"):
            assert getattr(c, f).dtype == want, f
    jcam = jconfig.load_stereo_camera("kitti_00_camera_left.txt", "kitti_00_camera_right.txt")
    np.testing.assert_allclose(cam.right.P.numpy(), np.asarray(jcam.right.P), rtol=1e-7)
    assert cam.right.p03 == float(cam.right.P[0, 3])
    one = config.camera_from_calibration(
        config.load_camera_calibration("kitti_00_camera_left.txt"), dtype, device=CPU)
    assert one.P.dtype == want
    default = pinhole_from_projection(P_KITTI_L, 1241, 376, device=CPU)
    assert default.P.dtype == torch.float32 and default.fx == float(np.float32(718.856))
