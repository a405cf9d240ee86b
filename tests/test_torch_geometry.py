"""Port vs JAX package: se3, linalg, camera.

Tolerance: ``atol 1e-5`` in float32 — both sides do the same float32
arithmetic, but sums inside the small matrix products are taken in another
order and sin/cos/acos come from different math libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.geometry import camera as jcamera
from svi_mapper_tpu.geometry import linalg as jlinalg
from svi_mapper_tpu.geometry import se3 as jse3
from svi_mapper_tpu.io.synthetic import default_camera as jdefault_camera
from svi_mapper_tpu_torch.geometry import linalg, se3

from torch_parity import t32, torch_camera

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _twists(rng, n=64):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    # rotation angles in [0, 2.5] rad: log is unique below pi
    xi[:, 3:] *= (rng.uniform(0.0, 2.5, (n, 1))
                  / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)).astype(np.float32)
    xi[:4, 3:] *= 1e-5                      # small-angle branch
    xi[4, 3:] = [np.pi - 1e-4, 0, 0]        # near-pi branch
    xi[5, 3:] = [0, -(np.pi - 5e-4), 0]
    return xi


def test_hat_vee_exp_log_so3(rng):
    xi = _twists(rng)
    phi = xi[:, 3:]
    _close(se3.hat(t32(phi)), jse3.hat(jnp.asarray(phi)), 0)
    R_t = se3.exp_so3(t32(phi))
    R_j = jse3.exp_so3(jnp.asarray(phi))
    _close(R_t, R_j)
    _close(se3.vee(se3.hat(t32(phi))), phi, 0)
    # same input rotation on both sides; near pi the log is ill-conditioned
    # in float32 (acos slope), so those two rows get 2e-3
    Rn = np.asarray(R_j)
    lt = se3.log_so3(t32(Rn)).numpy()
    lj = np.asarray(jse3.log_so3(jnp.asarray(Rn)))
    np.testing.assert_allclose(lt[6:], lj[6:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt[:6], lj[:6], atol=2e-3, rtol=0)


def test_exp_log_se3_roundtrip(rng):
    xi = _twists(rng)[6:]
    T_t = se3.exp_se3(t32(xi))
    _close(T_t, jse3.exp_se3(jnp.asarray(xi)))
    Tn = T_t.numpy()
    _close(se3.log_se3(t32(Tn)), jse3.log_se3(jnp.asarray(Tn)), 2e-5)
    # the float32 round trip itself (acos of a float32 trace) holds to 1e-3
    np.testing.assert_allclose(se3.log_se3(T_t).numpy(), xi, atol=1e-3)


def test_inv_transform_update(rng):
    xi = _twists(rng)[6:]
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    p = rng.normal(size=(T.shape[0], 3)).astype(np.float32) * 5
    _close(se3.inv_T(t32(T)), jse3.inv_T(jnp.asarray(T)))
    _close(se3.transform(t32(T), t32(p)), jse3.transform(jnp.asarray(T), jnp.asarray(p)))
    # one pose applied to many points (the frame step's use)
    _close(se3.transform(t32(T[0]), t32(p)),
           jse3.transform(jnp.asarray(T[0]), jnp.asarray(p)))
    d = (xi * 0.01).astype(np.float32)
    _close(se3.apply_left_update(t32(d), t32(T)),
           jse3.apply_left_update(jnp.asarray(d), jnp.asarray(T)))
    _close(se3.rotation_geodesic_angle(t32(T[:-1, :3, :3]), t32(T[1:, :3, :3])),
           jse3.rotation_geodesic_angle(jnp.asarray(T[:-1, :3, :3]),
                                        jnp.asarray(T[1:, :3, :3])), 1e-4)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    _close(se3.quat_to_R(t32(q)), jse3.quat_to_R(jnp.asarray(q)))


def test_linalg_closed_forms(rng):
    A = rng.normal(size=(32, 3, 3)).astype(np.float32)
    M3 = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    b3 = rng.normal(size=(32, 3)).astype(np.float32)
    _close(linalg.inv3x3(t32(M3)), jlinalg.inv3x3(jnp.asarray(M3)), 1e-4)
    _close(linalg.solve3x3(t32(M3), t32(b3)),
           jlinalg.solve3x3(jnp.asarray(M3), jnp.asarray(b3)), 1e-4)
    B = rng.normal(size=(16, 6, 6)).astype(np.float32)
    M6 = B @ B.transpose(0, 2, 1) + 1.0 * np.eye(6, dtype=np.float32)
    b6 = rng.normal(size=(16, 6)).astype(np.float32)
    x_t = linalg.solve6x6_spd(t32(M6), t32(b6))
    _close(x_t, jlinalg.solve6x6_spd(jnp.asarray(M6), jnp.asarray(b6)), 1e-4)
    np.testing.assert_allclose(
        np.einsum("nij,nj->ni", M6, x_t.numpy()), b6, atol=1e-3)


def test_camera_projection_and_fov(rng):
    jcam = jdefault_camera(512, 256)
    cam = torch_camera(jcam)
    assert cam.left.fx == float(np.asarray(jcam.left.fx))
    assert cam.baseline == pytest.approx(float(jcam.baseline), abs=1e-7)
    p = rng.normal(size=(200, 3)).astype(np.float32) * [4, 2, 1] + [0, 0, 12]
    p = p.astype(np.float32)
    for side_t, side_j in ((cam.left, jcam.left), (cam.right, jcam.right)):
        _close(side_t.project(t32(p)), side_j.project(jnp.asarray(p)), 1e-4)
    uv = rng.uniform(-20, 540, (300, 2)).astype(np.float32)
    uv[:4] = [[28, 28], [483, 227], [27.99, 100], [483.01, 100]]
    np.testing.assert_array_equal(
        cam.left.in_fov(t32(uv)).numpy(), np.asarray(jcam.left.in_fov(jnp.asarray(uv))))
    _close(cam.left.principal_weight(t32(uv)),
           jcam.left.principal_weight(jnp.asarray(uv)), 1e-6)
    depth = rng.uniform(1, 50, 300).astype(np.float32)
    _close(cam.left.back_project(t32(uv), t32(depth)),
           jcam.left.back_project(jnp.asarray(uv), jnp.asarray(depth)), 1e-4)
    _close(cam.left.normalize(t32(uv)), jcam.left.normalize(jnp.asarray(uv)), 1e-6)


def test_stereo_depth_and_triangulation(rng):
    jcam = jdefault_camera(512, 256)
    cam = torch_camera(jcam)
    d = rng.uniform(0.0, 120, 200).astype(np.float32)
    # depth = fx*b/d grows without bound as d -> 0: relative tolerance
    np.testing.assert_allclose(
        cam.depth_from_disparity(t32(d)).numpy(),
        np.asarray(jcam.depth_from_disparity(jnp.asarray(d))), rtol=1e-6)
    np.testing.assert_allclose(
        cam.disparity_from_depth(t32(d)).numpy(),
        np.asarray(jcam.disparity_from_depth(jnp.asarray(d))), rtol=1e-6)
    uv_l = rng.uniform(30, 480, (200, 2)).astype(np.float32)
    uv_r = uv_l - np.stack([d, np.zeros_like(d)], 1)
    np.testing.assert_allclose(
        cam.triangulate(t32(uv_l), t32(uv_r)).numpy(),
        np.asarray(jcam.triangulate(jnp.asarray(uv_l), jnp.asarray(uv_r))),
        rtol=1e-5, atol=1e-5)


def test_pinhole_from_projection_defaults():
    from svi_mapper_tpu_torch.geometry.camera import pinhole_from_projection

    P = np.array([[700.0, 0, 320, -350.0], [0, 700.0, 240, 0], [0, 0, 1, 0]])
    c = pinhole_from_projection(P, 640, 480, device="cpu")
    j = jcamera.pinhole_from_projection(P, 640, 480)
    for name in ("P", "K", "dist", "R_rect"):
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert (c.fx, c.fy, c.cx, c.cy, c.p03) == (700.0, 700.0, 320.0, 240.0, -350.0)
    assert c.P.dtype == torch.float32
