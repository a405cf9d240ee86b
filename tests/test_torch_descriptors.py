"""The port's patch descriptors (``ops/descriptors.py``: ``extract_patches``,
``brief_descriptors``, ``brief_descriptors_at_offsets``) against the JAX
package, bit for bit, on the same blurred image (mirrors the BRIEF tests of
``tests/test_ops.py``). Packed words cross as uint32 <-> int32 bit
patterns."""

import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.ops import descriptors as jd
from svi_mapper_tpu.ops.image import box_blur as j_blur
from svi_mapper_tpu_torch.ops import descriptors as td

from torch_parity import t32, unwords


def _smooth(rng, h=100, w=120):
    img = rng.random((h, w)).astype(np.float32)
    return np.asarray(j_blur(jnp.asarray(img), 5))


def test_patches_equal_including_borders_and_halves(rng):
    s = _smooth(rng)
    uv = np.array([[60.0, 50.0], [0.0, 0.0], [119.0, 99.0], [-40.0, 300.0],
                   [16.5, 17.5], [15.5, 16.5], [np.nan, 20.0], [1e9, -1e9]], np.float32)
    got = td.extract_patches(t32(s), t32(uv)).numpy()
    want = np.asarray(jd.extract_patches(jnp.asarray(s), jnp.asarray(uv)))
    assert got.shape == (8, 32, 32)
    np.testing.assert_array_equal(got, want)


def test_brief_descriptors_bit_exact(rng):
    s = _smooth(rng)
    uv = np.stack([rng.uniform(-5, 125, 64), rng.uniform(-5, 105, 64)], -1).astype(np.float32)
    got = td.brief_descriptors(t32(s), t32(uv))
    assert got.dtype.is_signed and tuple(got.shape) == (64, 8)
    np.testing.assert_array_equal(unwords(got),
                                  np.asarray(jd.brief_descriptors(jnp.asarray(s), jnp.asarray(uv))))
    # the same point the same descriptor, another point another
    d = unwords(td.brief_descriptors(t32(s), t32([[60.0, 50.0], [60.0, 50.0], [30.0, 40.0]])))
    assert np.array_equal(d[0], d[1]) and not np.array_equal(d[0], d[2])


def test_brief_descriptors_at_offsets_bit_exact(rng):
    s = _smooth(rng)
    uv = np.array([[60.0, 50.0], [40.0, 40.0], [100.0, 10.0]], np.float32)
    offs = np.array([[0.0, 0.0], [5.0, 0.0], [-3.0, 2.5], [0.0, -7.0]], np.float32)
    got = td.brief_descriptors_at_offsets(t32(s), t32(uv), t32(offs))
    assert tuple(got.shape) == (3, 4, 8)
    want = np.asarray(jd.brief_descriptors_at_offsets(jnp.asarray(s), jnp.asarray(uv),
                                                      jnp.asarray(offs)))
    np.testing.assert_array_equal(unwords(got), want)
    np.testing.assert_array_equal(unwords(got[:, 0]), unwords(td.brief_descriptors(t32(s), t32(uv))))


def test_patch_descriptors_match_the_dense_field(rng):
    """Away from the border the patch descriptor is the dense field's."""
    s = _smooth(rng, 100, 140)
    dense = td.brief_dense(t32(s))
    uv = np.stack([rng.uniform(20, 120, 32), rng.uniform(20, 80, 32)], -1).astype(np.float32)
    np.testing.assert_array_equal(unwords(td.brief_descriptors(t32(s), t32(uv))),
                                  unwords(td.brief_at(dense, t32(uv))))
