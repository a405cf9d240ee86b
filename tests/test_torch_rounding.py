"""Port vs JAX package: the pixel rounding of ``window_origin`` (K1's window),
``span_origin`` (K2's span) and ``brief_at``.

The JAX package rounds half to even, casts to int32 and clips; XLA's cast
saturates (and maps NaN to 0). The port clamps in float before the cast,
which gives the same integers for every input, on the CPU and on the card
(a wrapping cast would not: PyTorch's CPU cast of 3e9 to int32 gives
INT_MIN). The JAX expressions below are those of
``svi_mapper_tpu/frontend/tracking.py:135-139`` (=
``ops/track_kernel.py:240-244``) and ``ops/stereo_kernel.py:133-136``;
``brief_at`` is called as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.frontend import tracking as jtracking
from svi_mapper_tpu.ops import descriptors as jdesc
from svi_mapper_tpu_torch.ops import descriptors, stereo_kernel
from svi_mapper_tpu_torch.ops import track_kernel as tk

from torch_parity import t32, tint, words

H, W = 75, 203
VALUES = [3e9, -3e9, 1e20, -1e20, 2.0 ** 31 + 128, -(2.0 ** 31 + 128),
          2.0 ** 31 - 128, -(2.0 ** 31 - 128), 2.5, 3.5, -0.5, 0.5, 201.5, 202.5,
          np.nan, np.inf, -np.inf]
CUTS = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)


def _uv(value):
    """The value as u, as v and as both, beside an ordinary prediction."""
    return np.array([[value, 7.0], [9.0, value], [value, value], [100.2, 40.7]],
                    np.float32)


def _jax_pixel(uv, h, w):
    uvs = jnp.nan_to_num(jnp.asarray(uv), nan=0.0, posinf=0.0, neginf=0.0)
    u_r = jnp.clip(jnp.round(uvs[:, 0]).astype(jnp.int32), 0, w - 1)
    v_r = jnp.clip(jnp.round(uvs[:, 1]).astype(jnp.int32), 0, h - 1)
    return u_r, v_r


@pytest.mark.parametrize("value", VALUES)
def test_window_origin_equals_jax_rounding(value):
    uv = _uv(value)
    u_r, v_r = _jax_pixel(uv, H, W)
    want = [u_r, v_r, jnp.clip(u_r - tk.REACH_X, 0, W - tk.WIN_W),
            jnp.clip(v_r - tk.REACH_Y, 0, H - tk.WIN_H)]
    got = tk.window_origin(t32(uv), H, W)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("value", VALUES)
def test_span_origin_equals_jax_rounding(value):
    uv = _uv(value)
    De = 48
    u_r, v_r = _jax_pixel(uv, H, W)
    want = [u_r, v_r, jnp.clip(u_r - (De - 1), 0, W - De)]
    got = stereo_kernel.span_origin(t32(uv), H, W, De)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("value", VALUES)
def test_brief_at_equals_jax(value):
    """A field whose first word is the pixel's index shows which pixel was
    read."""
    field = np.zeros((H, W, 8), np.uint32)
    field[..., 0] = np.arange(H * W, dtype=np.uint32).reshape(H, W)
    field[..., 1] = 0xF0F0F0F0
    uv = _uv(value)
    got = descriptors.brief_at(words(field), t32(uv))
    want = jdesc.brief_at(jnp.asarray(field), jnp.asarray(uv))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_window_scores_with_far_predictions_equals_jax(rng):
    """Every landmark, all four outputs: predictions far outside the image
    (whose windows clamp to the image's edges and corners) among ordinary
    ones, with descriptors that match at the pixel the rounding picks."""
    L = len(VALUES) * 3 + 6
    dense = rng.integers(0, 2 ** 32, (H, W, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.concatenate([_uv(v)[:3] for v in VALUES] + [
        np.stack([rng.uniform(0, W - 1, 6), rng.uniform(0, H - 1, 6)], 1)]).astype(np.float32)
    u_r, v_r = (np.asarray(a) for a in _jax_pixel(uv, H, W))
    # the anchor and last descriptors of the pixel next to the rounded one
    dlast = dense[np.clip(v_r + 1, 0, H - 1), np.clip(u_r - 1, 0, W - 1)].copy()
    dlast[::4, 0] ^= np.uint32(0xFF)             # some over the stage-1 cutoff
    dref = dlast.copy()
    theta = rng.uniform(0, 2 * np.pi, L)
    band = (np.round(np.cos(theta) * 256).astype(np.int32),
            np.round(np.sin(theta) * 256).astype(np.int32),
            rng.integers(-800, 800, L).astype(np.int32),
            np.full(L, tk.REACH_X, np.int32), np.full(L, tk.REACH_Y, np.int32))
    got = tk.window_scores(words(dense), t32(uv), words(dlast), words(dref),
                           tuple(tint(b) for b in band), **CUTS)
    want = jtracking.window_scores(
        jnp.asarray(dense), jnp.asarray(uv), jnp.asarray(dlast), jnp.asarray(dref),
        tuple(jnp.asarray(b) for b in band), **CUTS)
    assert int((np.asarray(want[0]) < tk.BIG).sum()) >= L // 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
