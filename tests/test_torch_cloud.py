"""The port's keyframe cloud files (``io/cloud.py``) against the JAX
package's (mirrors the cloud tests of ``tests/test_io_eval.py``): the same
``.npz`` format, version 1, a file written by either read by the other with
the same arrays, descriptors as uint32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io import cloud as jcloud
from svi_mapper_tpu.models import frame as jframe
from svi_mapper_tpu_torch.io import cloud as cloud_mod
from svi_mapper_tpu_torch.utils.errors import InvalidFileError

from torch_parity import torch_state

FIELDS = ("T_wc", "uids", "points_w", "points_cam", "uv_left", "uv_right", "descriptors")


def _cloud(mod, rng):
    return mod.KeyframeCloud(
        keyframe_id=3, frame_idx=42, T_wc=np.eye(4, dtype=np.float32),
        uids=np.arange(10, dtype=np.int64),
        points_w=rng.random((10, 3)).astype(np.float32),
        points_cam=rng.random((10, 3)).astype(np.float32),
        uv_left=rng.random((10, 2)).astype(np.float32),
        uv_right=rng.random((10, 2)).astype(np.float32),
        descriptors=rng.integers(0, 2**32, (10, 8), dtype=np.uint64).astype(np.uint32))


def _equal(a, b):
    assert (a.keyframe_id, a.frame_idx) == (b.keyframe_id, b.frame_idx)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_cloud_roundtrip_and_cross_package(tmp_path, rng):
    c = _cloud(cloud_mod, rng)
    cloud_mod.save_cloud(tmp_path / "port.npz", c)
    c2 = cloud_mod.load_cloud(tmp_path / "port.npz")
    assert c2.keyframe_id == 3 and c2.frame_idx == 42
    assert c2.descriptors.dtype == np.uint32
    np.testing.assert_array_equal(c2.descriptors, c.descriptors)
    # the port's file in the JAX package, the JAX package's file in the port
    _equal(jcloud.load_cloud(tmp_path / "port.npz"), c2)
    jcloud.save_cloud(tmp_path / "jax.npz", _cloud(jcloud, np.random.default_rng(1)))
    _equal(cloud_mod.load_cloud(tmp_path / "jax.npz"),
           jcloud.load_cloud(tmp_path / "jax.npz"))
    # int32 bit patterns (the port's descriptor dtype) are written as uint32
    c.descriptors = c.descriptors.view(np.int32)
    cloud_mod.save_cloud(tmp_path / "i32.npz", c)
    np.testing.assert_array_equal(cloud_mod.load_cloud(tmp_path / "i32.npz").descriptors,
                                  c2.descriptors)


def test_future_version_and_native_suffix(tmp_path, rng):
    path = tmp_path / "c.npz"
    cloud_mod.save_cloud(path, _cloud(cloud_mod, rng))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["format_version"] = np.asarray(2)
    np.savez_compressed(path, **arrays)
    with pytest.raises(InvalidFileError, match="version"):
        cloud_mod.load_cloud(path)
    for fn in (lambda p: cloud_mod.save_cloud(p, _cloud(cloud_mod, rng)),
               cloud_mod.load_cloud):
        with pytest.raises(NotImplementedError, match="7c"):
            fn(tmp_path / "kf.svic")


def test_cloud_from_slam_state(rng):
    params = dataclasses.replace(JPARAMS, max_landmarks=16, max_measurements=4)
    state = jframe.init_state(params)
    t = state.table.replace(
        active=jnp.asarray([True] * 8 + [False] * 8),
        is_optimal=jnp.asarray([True] * 4 + [False] * 12),
        uid=jnp.arange(16, dtype=jnp.int32),
        pos_w=jnp.asarray(rng.random((16, 3)).astype(np.float32)),
        uv_left_last=jnp.asarray(rng.uniform(0, 500, (16, 2)).astype(np.float32)),
        disparity_last=jnp.asarray(rng.uniform(1, 50, 16).astype(np.float32)),
        desc_left_ref=jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint64)
                                  .astype(np.uint32)))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.5, -0.2, 3.0]
    state = state.replace(table=t, T_wc=jnp.asarray(T))
    want = jcloud.cloud_from_slam_state(state, keyframe_id=0, frame_idx=5)
    got = cloud_mod.cloud_from_slam_state(torch_state(state), keyframe_id=0, frame_idx=5)
    assert len(got.uids) == 4                 # active AND optimal
    assert got.points_cam.shape == (4, 3)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)).astype(getattr(got, f).dtype),
                                      err_msg=f)
