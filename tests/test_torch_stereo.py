"""Port vs JAX package: ``match_stereo`` against BOTH JAX branches — the
XLA row-span path (``force_kernel=False``) and the Pallas profile kernel in
interpret mode (``force_kernel=True``).

``ok`` and ``distance`` are integer decisions and compared exactly;
``disparity`` comes out of a float32 parabola and is held to 1e-5; values
only matter where a match was accepted.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from svi_mapper_tpu.frontend.stereo import match_stereo as jmatch
from svi_mapper_tpu.io.synthetic import SyntheticSequence, default_camera
from svi_mapper_tpu.ops.descriptors import brief_at as jbrief_at
from svi_mapper_tpu.ops.descriptors import smooth_brief_dense as jsmooth
from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.ops import stereo_kernel as sk

from torch_parity import t32, tbool, torch_camera, words


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(n_frames=1, width=512, height=256, step=0.8)
    l, r, _ = seq.frame(0)
    return seq.cam, jsmooth(jnp.asarray(l)), jsmooth(jnp.asarray(r))


def _compare(got, want, n_min):
    ok = np.asarray(want.ok)
    assert int(ok.sum()) >= n_min
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.distance.numpy()[ok], np.asarray(want.distance)[ok])
    np.testing.assert_allclose(got.disparity.numpy()[ok], np.asarray(want.disparity)[ok],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.uv_right.numpy()[ok], np.asarray(want.uv_right)[ok],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.depth.numpy()[ok], np.asarray(want.depth)[ok], rtol=1e-5)
    np.testing.assert_allclose(got.p_cam.numpy()[ok], np.asarray(want.p_cam)[ok],
                               rtol=1e-4, atol=1e-4)


def _run(scene, uv, n_min, kernel, valid=None, **kw):
    cam, dense_l, dense_r = scene
    K = uv.shape[0]
    valid = np.ones(K, bool) if valid is None else valid
    desc = jbrief_at(dense_l, jnp.asarray(uv))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (t32(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = jmatch(dense_r, jnp.asarray(uv), desc, jnp.asarray(valid), cam,
                  force_kernel=kernel, **jkw)
    got = match_stereo(words(dense_r), t32(uv), words(desc), tbool(valid),
                       torch_camera(cam), **tkw)
    _compare(got, want, n_min)


@pytest.mark.parametrize("kernel", [False, True])
def test_match_stereo_unbounded(scene, rng, kernel):
    uv = np.stack([rng.uniform(0, 511, 256), rng.uniform(0, 255, 256)], 1).astype(np.float32)
    valid = rng.integers(0, 5, 256) > 0
    _run(scene, uv, 40, kernel, valid=valid)


@pytest.mark.parametrize("kernel", [False, True])
def test_match_stereo_with_disparity_bounds(scene, rng, kernel):
    K = 128
    uv = np.stack([rng.uniform(30, 480, K), rng.uniform(10, 250, K)], 1).astype(np.float32)
    _run(scene, uv, 5, kernel,
         disparity_center=rng.uniform(2, 50, K).astype(np.float32),
         search_range=rng.uniform(5, 60, K).astype(np.float32))
    # center given, range left to its 60 px default
    _run(scene, uv, 5, kernel,
         disparity_center=rng.uniform(2, 50, K).astype(np.float32))


@pytest.mark.parametrize("kernel", [False, True])
def test_match_stereo_gates_and_small_disparity_cap(scene, rng, kernel):
    K = 128
    uv = np.stack([rng.uniform(0, 511, K), rng.uniform(0, 255, K)], 1).astype(np.float32)
    _run(scene, uv, 10, kernel, max_disparity=48, cutoff=60,
         min_disparity=2.0, min_depth=3.0, max_depth=60.0)


@pytest.mark.parametrize("kernel", [False, True])
def test_match_stereo_nan_keypoints(scene, rng, kernel):
    """NaN keypoints are never accepted and poison nothing else. Infinite
    coordinates are zeroed first, as the Pallas branch does (the XLA branch
    saturates them to the image edge instead, so only the kernel branch is
    compared on that row; the frame step never produces one)."""
    K = 64
    uv = np.stack([rng.uniform(60, 500, K), rng.uniform(5, 250, K)], 1).astype(np.float32)
    uv[3] = [np.nan, 40.0]
    uv[7] = [100.0, np.nan]
    uv[11] = [np.nan, np.nan]
    if kernel:
        uv[12] = [np.inf, -np.inf]
    cam, dense_l, dense_r = scene
    desc = jbrief_at(dense_l, jnp.asarray(uv))
    want = jmatch(dense_r, jnp.asarray(uv), desc, jnp.ones(K, bool), cam,
                  force_kernel=kernel)
    got = match_stereo(words(dense_r), t32(uv), words(desc),
                       tbool(np.ones(K, bool)), torch_camera(cam))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert not got.ok.numpy()[[3, 11]].any()
    ok = np.asarray(want.ok)
    assert ok.sum() > 20
    np.testing.assert_array_equal(got.distance.numpy()[ok], np.asarray(want.distance)[ok])


@pytest.mark.parametrize("kernel", [False, True])
def test_match_stereo_image_narrower_than_search_range(rng, kernel):
    """W = 96 < max_disparity = 128: the span clamps to the image width."""
    h, w, K = 64, 96, 48
    jcam = default_camera(w, h)
    dense_r = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(0, w - 1, K), rng.uniform(0, h - 1, K)], 1).astype(np.float32)
    # the true match of keypoint k sits d_k pixels to the left
    d_true = rng.integers(1, 40, K)
    desc = np.zeros((K, 8), np.uint32)
    for k in range(K):
        x = int(np.clip(round(float(uv[k, 0])) - d_true[k], 0, w - 1))
        desc[k] = dense_r[int(round(float(uv[k, 1]))), x]
    want = jmatch(jnp.asarray(dense_r), jnp.asarray(uv), jnp.asarray(desc),
                  jnp.ones(K, bool), jcam, force_kernel=kernel)
    got = match_stereo(words(dense_r), t32(uv), words(desc),
                       tbool(np.ones(K, bool)), torch_camera(jcam))
    assert got.distance.shape == (K,)
    _compare(got, want, 20)


def test_profile_layout_and_cpu_dispatch(rng):
    """profile[k, i] is the distance at column x0 + De-1 - i; a CPU field
    takes the plain version and launches nothing."""
    h, w, K, D = 40, 200, 16, 64
    dense = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(0, w - 1, K), rng.uniform(0, h - 1, K)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    before = sk.stereo_profiles_launches
    prof, u_r, x0 = sk.stereo_profiles(words(dense), t32(uv), words(desc), max_disparity=D)
    assert sk.stereo_profiles_launches == before
    assert prof.shape == (K, D)
    u_np = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
    v_np = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
    x0_np = np.clip(u_np - (D - 1), 0, w - D)
    np.testing.assert_array_equal(x0.numpy(), x0_np)
    np.testing.assert_array_equal(u_r.numpy(), u_np)
    for k in (0, 5, 15):
        for i in (0, 17, D - 1):
            px = dense[v_np[k], x0_np[k] + D - 1 - i]
            want = sum(bin(int(a ^ b)).count("1") for a, b in zip(px, desc[k]))
            assert int(prof[k, i]) == want
