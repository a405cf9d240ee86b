"""The port's corridor renderer against the JAX one.

Both evaluate the same 48-wave sine sum in float32 from the same numpy-made
parameters; phases reach hundreds of radians, so the two sine
implementations differ in the last bits and a pixel whose sum lies within
that of zero lands on the other side of the hard texture threshold (a jump
of 0.75 * 255 grey levels). Hence two bounds: mean absolute difference under
0.5 grey level, and under 0.1 % of pixels across the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu_torch.io import synthetic as syn

from torch_parity import t32


def test_texture_parameters_and_world_identical():
    for a, b in zip(syn._make_texture_params(), (jsyn._OMEGA, jsyn._PHASE, jsyn._AMP)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert syn._PLANES == jsyn._PLANES


def test_corridor_trajectory_matches():
    a = syn.corridor_trajectory(12, step=0.5)
    b = jsyn.corridor_trajectory(12, step=0.5)
    assert a.shape == b.shape == (12, 4, 4) and a.dtype == np.float32
    # (1 - cos t) / t^2 at t ~ 3e-3 rad cancels in float32, so the two math
    # libraries give the per-step twist slightly different translations
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_default_camera_matches():
    c = syn.default_camera(512, 256, device="cpu")
    j = jsyn.default_camera(512, 256)
    np.testing.assert_array_equal(c.left.P.numpy(), np.asarray(j.left.P))
    np.testing.assert_array_equal(c.right.P.numpy(), np.asarray(j.right.P))
    assert (c.width, c.height) == (512, 256)


def test_raycast_matches(rng):
    j = jsyn.default_camera(256, 128)
    T = jsyn.corridor_trajectory(3)[2]
    args = (float(j.left.fx), float(j.left.cx), float(j.left.cy), 0.54, 256, 128)
    o_t, d_t, t_t = syn.raycast(t32(T), *args)
    o_j, d_j, t_j = jsyn.raycast(jnp.asarray(T), *[jnp.float32(a) if i < 4 else a
                                                   for i, a in enumerate(args)])
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    t_j = np.asarray(t_j)
    np.testing.assert_array_equal(np.isfinite(t_t.numpy()), np.isfinite(t_j))
    m = np.isfinite(t_j)
    np.testing.assert_allclose(t_t.numpy()[m], t_j[m], rtol=1e-4)


@pytest.mark.parametrize("frame", [0, 7])
def test_render_stereo_close(frame):
    jseq = jsyn.SyntheticSequence(n_frames=8, width=512, height=256, step=0.5)
    tseq = syn.SyntheticSequence(n_frames=8, width=512, height=256, step=0.5,
                                 device="cpu")
    np.testing.assert_allclose(tseq.poses_wc, jseq.poses_wc, atol=1e-4)
    assert tseq.frame(frame)[2].shape == (4, 4)
    assert next(iter(tseq))[0].shape == (256, 512)
    # the same pose through both renderers
    jl, jr, T = jseq.frame(frame)
    tl, tr = syn.render_stereo(tseq.cam, T)
    for a, b in ((tl, jl), (tr, jr)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (256, 512) and a.dtype == np.float32
        assert np.isfinite(a).all()
        d = np.abs(a - b)
        assert d.mean() < 0.5
        assert (d > 100.0).mean() < 1e-3      # pixels across the threshold
    # left and right differ (there is a baseline) but share the world
    assert np.abs(tl.numpy() - tr.numpy()).mean() > 1.0


def test_unknown_trajectory_rejected():
    with pytest.raises(ValueError):
        syn.SyntheticSequence(n_frames=2, trajectory="spiral", device="cpu")


@pytest.mark.parametrize("n,radius,per_loop", [(30, 12.0, None), (46, 26.0, 40), (8, 5.0, 8)])
def test_loop_trajectory_matches(n, radius, per_loop):
    a = syn.loop_trajectory(n, radius, frames_per_loop=per_loop)
    b = jsyn.loop_trajectory(n, radius, frames_per_loop=per_loop)
    assert a.shape == b.shape == (n, 4, 4) and a.dtype == np.float32
    # steps of 0.15 .. 0.8 rad: the twist's series are well conditioned
    np.testing.assert_allclose(a, b, atol=1e-6)
    if per_loop == n:                    # one full turn comes home
        np.testing.assert_allclose(a[-1], np.eye(4), atol=1e-4)


@pytest.mark.parametrize("radius,kw", [(100.0, {}), (26.0, dict(n_segments=8)),
                                       (6.0, dict(half_width=9.0))])
def test_ring_world_planes_equal(radius, kw):
    a, b = syn.ring_world(radius, **kw), jsyn.ring_world(radius, **kw)
    assert a == b
    # a ring narrower than its half width has no inner fence
    assert len(a) == 1 + (2 if radius > 10 else 1) * kw.get("n_segments", 16)


def test_ring_frame_close():
    """A frame of a loop sequence in the ring world, through both renderers,
    within the bounds of the corridor frames above."""
    world = syn.ring_world(26.0)
    jseq = jsyn.SyntheticSequence(n_frames=12, width=384, height=192, trajectory="loop",
                                  loop_radius=26.0, world=jsyn.ring_world(26.0))
    tseq = syn.SyntheticSequence(n_frames=12, width=384, height=192, trajectory="loop",
                                 loop_radius=26.0, world=world, device="cpu")
    np.testing.assert_allclose(tseq.poses_wc, jseq.poses_wc, atol=1e-6)
    jl, jr, T = jseq.frame(5)
    tl, tr, T_t = tseq.frame(5)
    np.testing.assert_array_equal(T_t, tseq.poses_wc[5])
    for a, b in ((tl, jl), (tr, jr)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (192, 384) and np.isfinite(a).all()
        d = np.abs(a - b)
        assert d.mean() < 0.5
        assert (d > 100.0).mean() < 1e-3
    # the world is in view: most pixels hit a plane, and not the corridor's
    assert (tl.numpy() > 0).mean() > 0.5
    corridor = syn.render_stereo(tseq.cam, tseq.poses_wc[5])[0].numpy()
    assert np.abs(corridor - tl.numpy()).mean() > 1.0
