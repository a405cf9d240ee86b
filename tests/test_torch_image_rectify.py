"""The image ops of the stereo-inertial path (``ops/image.py``:
``equalize_hist``, ``remap_bilinear``, ``gaussian_blur``, ``pad_to_multiple``,
and the host-side ``stereo_rectify`` / ``undistort_rectify_maps``) against
the JAX package's on the same numpy inputs (mirrors the rectification half of
``tests/test_euroc.py``).

Tolerances: ``equalize_hist`` exact against the compiled JAX function (its
output feeds the BRIEF comparisons). ``remap_bilinear`` and ``gaussian_blur``
exact against the JAX functions evaluated op by op (``jax.disable_jit``),
which is the order the code states. Compiled by XLA on the CPU, the JAX
blend ``a * (1 - t) + b * t`` is contracted to ``fma(a, 1 - t, b * t)``
(shown below), which rounds once instead of twice: against that the port is
within 3.1e-5 (found: 3.05e-5, 3 ulps, on [0, 255]); the port rounds every
step on its own, on the CPU and on the card alike. The rectification is float64 numpy
on both sides: 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.ops import image as j_img
from svi_mapper_tpu_torch import config
from svi_mapper_tpu_torch.ops import image as t_img

from torch_parity import t32


def _u8(rng, shape, kind):
    if kind == "random":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "constant":
        return np.full(shape, 93, np.uint8)
    if kind == "two_level":
        return np.where(rng.random(shape) < 0.3, 12, 240).astype(np.uint8)
    if kind == "all_levels":
        img = np.arange(np.prod(shape)) % 256
        return rng.permutation(img).reshape(shape).astype(np.uint8)
    if kind == "dark_skewed":
        return np.clip(rng.gamma(1.5, 9.0, shape), 0, 255).astype(np.uint8)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "constant", "two_level", "all_levels",
                                  "dark_skewed"])
@pytest.mark.parametrize("shape", [(48, 64), (480, 752)])
def test_equalize_hist_exact(rng, kind, shape):
    img = _u8(rng, shape, kind)
    want = np.asarray(j_img.equalize_hist(jnp.asarray(img)))
    got = t_img.equalize_hist(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_u8_truncates_as_the_jax_package_does():
    x = np.array([-3.0, 0.0, 0.4, 0.99, 1.0, 127.5, 254.99, 255.0, 300.0, 1e9,
                  -np.inf, np.inf, np.nan], np.float32)
    want = np.asarray(jnp.clip(jnp.asarray(x), 0, 255).astype(jnp.uint8))
    np.testing.assert_array_equal(t_img.to_u8(t32(x)).numpy(), want)


def _maps(rng, h, w, out_shape, extreme):
    my = rng.uniform(-0.3 * h, 1.3 * h, out_shape).astype(np.float32)
    mx = rng.uniform(-0.3 * w, 1.3 * w, out_shape).astype(np.float32)
    if extreme:
        bad = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e20, -1e20, -0.5, w - 0.5, w + 0.0,
               -1.0, np.float32(w - 1) + 0.999]
        for i, b in enumerate(bad):
            mx[0, i] = b
            my[1, i] = b
            my[2, i] = b
            mx[2, i] = bad[-1 - i]
    return mx, my


def _remap_both(img, mx, my, jit: bool):
    args = (jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
    if jit:
        want = np.asarray(j_img.remap_bilinear(*args))
    else:
        with jax.disable_jit():
            want = np.asarray(j_img.remap_bilinear(*args))
    got = t_img.remap_bilinear(t32(img), t32(mx), t32(my)).numpy()
    return want, got


@pytest.mark.parametrize("extreme", [False, True])
def test_remap_bilinear_exact_op_by_op(rng, extreme):
    """Negative, out-of-range and non-finite map coordinates included: the
    index is clamped in float before the cast, so no value reaches an
    undefined conversion."""
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    mx, my = _maps(rng, 48, 64, (40, 50), extreme)
    want, got = _remap_both(img, mx, my, jit=False)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


def test_remap_bilinear_against_compiled_jax(rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    mx, my = _maps(rng, 120, 160, (120, 160), extreme=False)
    want, got = _remap_both(img, mx, my, jit=True)
    assert np.abs(got - want).max() <= 3.1e-5
    # XLA's contraction, restated: fma(a, 1 - t, b * t) at every blend
    x0, y0 = np.floor(mx), np.floor(my)
    fx, fy = mx - x0, my - y0
    xi = np.clip(x0.astype(np.int64), 0, 159)
    yi = np.clip(y0.astype(np.int64), 0, 119)
    xj, yj = np.clip(xi + 1, 0, 159), np.clip(yi + 1, 0, 119)

    def fma_blend(a, b, t):
        bt = (b * t).astype(np.float32)
        return (a.astype(np.float64) * (1 - t).astype(np.float64) + bt).astype(np.float32)

    top = fma_blend(img[yi, xi], img[yi, xj], fx)
    bot = fma_blend(img[yj, xi], img[yj, xj], fx)
    np.testing.assert_array_equal(fma_blend(top, bot, fy), want)


def test_remap_with_identity_maps_is_the_image(rng):
    img = rng.uniform(0, 255, (32, 40)).astype(np.float32)
    u, v = np.meshgrid(np.arange(40, dtype=np.float32), np.arange(32, dtype=np.float32))
    np.testing.assert_array_equal(t_img.remap_bilinear(t32(img), t32(u), t32(v)).numpy(), img)


@pytest.mark.parametrize("sigma,radius", [(2.0, 4), (1.0, 2), (3.5, 6)])
def test_gaussian_blur_exact_op_by_op(rng, sigma, radius):
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    np.testing.assert_array_equal(t_img._gaussian_kernel(sigma, radius),
                                  j_img._gaussian_kernel(sigma, radius))
    with jax.disable_jit():
        want = np.asarray(j_img.gaussian_blur(jnp.asarray(img), sigma, radius))
    got = t_img.gaussian_blur(t32(img), sigma, radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,multiple", [((37, 53), 128), ((128, 256), 128),
                                            ((376, 1241), 16), ((5, 7), 4)])
def test_pad_to_multiple_exact(rng, shape, multiple):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(j_img.pad_to_multiple(jnp.asarray(img), multiple))
    got = t_img.pad_to_multiple(t32(img), multiple).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# rectification (host-side float64)
# ---------------------------------------------------------------------------

def _rot(v):
    a = np.linalg.norm(v)
    if a < 1e-12:
        return np.eye(3)
    k = v / a
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def _vi_sensor_pair():
    """The shipped VI-sensor rig: both cameras' raw K and distortion, and
    their relative pose ``x1 = T_10 x0`` from each file's pose to the IMU
    (``CameraCalibration.T_cam_imu``)."""
    cl = config.load_camera_calibration("vi_sensor_camera_left.txt")
    cr = config.load_camera_calibration("vi_sensor_camera_right.txt")
    return cl, cr, cr.T_cam_imu @ np.linalg.inv(cl.T_cam_imu)


def _cases():
    K0 = np.array([[458.0, 0, 367.0], [0, 457.0, 248.0], [0, 0, 1]])
    K1 = np.array([[455.0, 0, 379.0], [0, 456.0, 255.0], [0, 0, 1]])
    T10 = np.eye(4)
    T10[:3, :3] = _rot(np.array([0.01, -0.02, 0.015]))
    T10[:3, 3] = [-0.11, 0.002, -0.001]
    cl, cr, T_vi = _vi_sensor_pair()
    return {
        "synthetic": (K0, np.zeros(4), K1, np.zeros(4), T10, 752, 480),
        "distorted": (K0, np.array([-0.28, 0.07, -9e-4, -9e-6]), K1,
                      np.array([-0.27, 0.06, 3e-4, 2e-5]), T10, 752, 480),
        "vi_sensor": (cl.K, cl.dist, cr.K, cr.dist, T_vi, cl.width, cl.height),
    }


@pytest.mark.parametrize("case", ["synthetic", "distorted", "vi_sensor"])
def test_stereo_rectify_and_maps_match(case):
    K0, d0, K1, d1, T10, w, h = _cases()[case]
    want = j_img.stereo_rectify(K0, d0, K1, d1, T10, w, h)
    got = t_img.stereo_rectify(K0, d0, K1, d1, T10, w, h)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    R0, R1, P0, P1 = got
    # valid rotations with R_rect1 R = R_rect0, and the left-camera
    # baseline convention P1[0,3] = -fx * |t| (tests/test_euroc.py)
    for Rr in (R0, R1):
        assert np.allclose(Rr @ Rr.T, np.eye(3), atol=1e-10)
    assert np.allclose(R1 @ T10[:3, :3], R0, atol=1e-10)
    assert P1[0, 3] < 0
    assert abs(-P1[0, 3] / P1[0, 0] - np.linalg.norm(T10[:3, 3])) < 1e-9
    if case == "vi_sensor":
        # the baseline the right file's rectified projection states (0.1102 m)
        P_R = config.load_camera_calibration("vi_sensor_camera_right.txt").P
        assert abs(-P1[0, 3] / P1[0, 0] + P_R[0, 3] / P_R[0, 0]) < 1e-3
    for K, d, Rr, P in ((K0, d0, R0, P0), (K1, d1, R1, P1)):
        mj = j_img.undistort_rectify_maps(K, d, Rr, P, w, h)
        mt = t_img.undistort_rectify_maps(K, d, Rr, P, w, h)
        for a, b in zip(mt, mj):
            assert a.dtype == np.float32 and a.shape == (h, w)
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)


def test_stereo_rectify_aligns_rows():
    """Random points project to equal rows with positive disparity, and depth
    from disparity recovers the rectified depth (tests/test_euroc.py)."""
    K0, d0, K1, d1, T10, w, h = _cases()["synthetic"]
    R0, R1, P0, P1 = t_img.stereo_rectify(K0, d0, K1, d1, T10, w, h)
    rng = np.random.default_rng(11)
    p0 = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50),
                   rng.uniform(4, 30, 50)], -1)
    p1 = p0 @ T10[:3, :3].T + T10[:3, 3]
    pr0 = p0 @ R0.T
    assert np.allclose(p1 @ R1.T - pr0, (R1 @ T10[:3, 3])[None, :], atol=1e-9)

    def project(P, p):
        uvw = np.concatenate([p, np.ones_like(p[:, :1])], 1) @ P.T
        return uvw[:, :2] / uvw[:, 2:3]

    uv0, uv1 = project(P0, pr0), project(P1, pr0)
    assert np.abs(uv0[:, 1] - uv1[:, 1]).max() < 1e-6
    disparity = uv0[:, 0] - uv1[:, 0]
    assert (disparity > 0).all()
    assert np.allclose(-P1[0, 3] / disparity, pr0[:, 2], rtol=1e-6)


def test_rectify_maps_identity_when_already_rectified():
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]])
    P = np.hstack([K, np.zeros((3, 1))])
    mx, my = t_img.undistort_rectify_maps(K, np.zeros(4), np.eye(3), P, 64, 48)
    u, v = np.meshgrid(np.arange(64, dtype=np.float32), np.arange(48, dtype=np.float32))
    assert np.allclose(mx, u, atol=1e-4) and np.allclose(my, v, atol=1e-4)


@pytest.mark.parametrize("equalize", [False, True])
@pytest.mark.parametrize("kind", ["random", "two_level", "dark_skewed", "float_range"])
def test_svi_preprocess_matches_jax_method(rng, equalize, kind):
    """``StereoInertialTracker.preprocess`` against the JAX method, bit for
    bit on uint8-range input, with ``equalize`` on and off: the raw frame
    as a uint8 array, and as float32 values in [0, 255] with fractions (the
    uint8 truncation runs only when equalizing). Both methods read only the
    tracker's ``equalize`` (and the port's its ``device``), so they are
    called on a stand-in that carries those."""
    from types import SimpleNamespace

    from svi_mapper_tpu.models.svi import StereoInertialTracker as JaxSVI
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker as PortSVI

    if kind == "float_range":
        img = (rng.random((48, 64)) * 255.0).astype(np.float32)
    else:
        img = _u8(rng, (48, 64), kind)
    want = np.asarray(JaxSVI.preprocess(SimpleNamespace(equalize=equalize), img))
    got = PortSVI.preprocess(SimpleNamespace(equalize=equalize, device=torch.device("cpu")),
                             img)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy(), want)
