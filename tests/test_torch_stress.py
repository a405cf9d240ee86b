"""The photometric stress worlds of the port (``io/stress.py``) and the
aliased corridor (``io/synthetic.py`` ``alias_period``) against the JAX
package, mirroring the renderer tests of ``tests/test_stress.py``.

The read noise is the JAX package's own stream: Threefry-2x32 restated on
int64 tensors gives ``jax.random.bits`` bit for bit, and the normal
deviates agree to the last bits of ``erfinv`` (the two libraries' float32
``erfinv`` differ by up to ~1e-5 at |x| ~ 4). The rest of the render is the
same float32 arithmetic in another library (sigmoid, ``pow``, ``sin``), so
before the final rounding to 8 bits a pixel can lie an ulp on the other
side of a half: the renders are held to at most 0.1 % of pixels 1 DN apart,
and at most 0.1 % further apart (pixels whose texture sum lies within the
sine libraries' difference of the hard threshold, as
``test_torch_synthetic.py`` bounds them). Found: at most 6e-5 of pixels
1 DN apart, none further, at 128 x 64 and 256 x 128.

The lock step runs 16 stressed frames at 256 x 128 (the moderate preset)
through the JAX ``StereoTracker`` and, from its state before every frame,
the port's ``process_frame``. Its bounds are looser than those of
``test_torch_loop_lockstep.py`` (1e-3 m at 376 x 1241 on clean renders), for
two stated reasons. At 256 x 128 a frame tracks 50-90 landmarks, and one
borderline match flipped by float order moves the pose by millimetres (the
clean render gives 9.0e-3 m there too). And on 8-bit images the two
packages' dense BRIEF fields differ in ~5 % of words (ROADMAP F13): XLA:CPU
fuses the JAX package's jitted box blur and rounds it otherwise than its own
unfused ops, which the port computes exactly (37 % of blurred pixels differ
by up to 4.6e-5), and integer pixel values make exact ties in the BRIEF
comparisons common, so the rounding decides them.
``test_dense_field_differs_only_by_the_blur`` shows that mechanism: given
the JAX package's blurred image, the port's field is the JAX field bit for
bit. Bounds: ``posit_ok``, ``is_keyframe`` and ``instability`` equal,
``n_tracked`` and ``inliers`` within 1 % of the capacity (2), the pose
within 2e-2 m and 2e-3 rad (found: 1.0e-2 m and 7.4e-4 rad at frame 1, one
count 1 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io import stress as jst
from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu.models.tracker import StereoTracker as JTracker
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.io import stress as st
from svi_mapper_tpu_torch.io import synthetic as syn
from svi_mapper_tpu_torch.models import frame as frame_mod

from torch_parity import torch_camera, torch_state

CPU = "cpu"
SHARE_1DN = 1e-3
SHARE_FLIP = 1e-3


def _cam(w=128, h=64):
    return syn.default_camera(w, h, device=CPU)


def _pair(level, i=3, w=128, h=64, T=None):
    T = np.eye(4, dtype=np.float32) if T is None else T
    return [a.numpy() for a in st.render_stressed_stereo(_cam(w, h), T, i, st.PRESETS[level])]


def _assert_close_render(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert a.shape == b.shape
    assert ((d > 0) & (d <= 1)).mean() <= SHARE_1DN, ((d > 0) & (d <= 1)).mean()
    assert (d > 1).mean() <= SHARE_FLIP, (d > 1).mean()


def test_presets_and_params_equal():
    assert {k: dataclasses.asdict(v) for k, v in st.PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jst.PRESETS.items()}
    assert hash(st.MODERATE) == hash(dataclasses.replace(st.MODERATE))
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.MODERATE.noise_std = 1.0


@pytest.mark.parametrize("level", ["clean", "mild", "moderate", "severe"])
def test_render_matches_jax(level):
    """Each preset, both views, three frames (exposure phases, drifting
    occluders, noise keys), from a pose inside the corridor."""
    T = jsyn.corridor_trajectory(6, step=0.5)[5]
    jcam = jsyn.default_camera(128, 64)
    for i in (0, 3, 11):
        got = st.render_stressed_stereo(_cam(), T, i, st.PRESETS[level])
        want = jst.render_stressed_stereo(jcam, jnp.asarray(T), i, jst.PRESETS[level])
        for a, b in zip(got, want):
            assert a.dtype == np.float32 or str(a.dtype) == "torch.float32"
            _assert_close_render(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,frame,view", [(0, 0, 0), (0, 7, 1), (5, 3, 0), (123, 201, 1)])
def test_noise_stream_matches_jax(seed, frame, view):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), frame * 2 + view)
    key = st.fold_in(st.prng_key(seed), frame * 2 + view)
    assert key == tuple(int(x) for x in np.asarray(jkey))
    shape = (37, 53)                     # odd sizes: no pairing of counters
    bits = st.random_bits(key, shape, CPU).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
    z = st.normal(key, shape, CPU).numpy()
    np.testing.assert_allclose(z, np.asarray(jax.random.normal(jkey, shape, jnp.float32)),
                               rtol=1e-5, atol=2e-5)


def test_stress_deterministic():
    np.testing.assert_array_equal(_pair("severe")[0], _pair("severe")[0])


def test_clean_preset_matches_quantized_clean_render():
    clean = np.clip(np.round(syn.render_stereo(_cam(), np.eye(4))[0].numpy()), 0, 255)
    np.testing.assert_allclose(_pair("clean")[0], clean, atol=1.0)


def test_noise_level_measured():
    """Mild preset noise_std=2: the difference from the noise-free variant
    of the same preset must measure ~2 DN (quantization adds ~0.29)."""
    sp = dataclasses.replace(st.MILD, noise_std=0.0)
    no_noise = st.render_stressed_stereo(_cam(), np.eye(4), 3, sp)[0].numpy()
    d = _pair("mild")[0] - no_noise
    assert 1.2 < d.std() < 3.0


def test_exposure_drift_changes_over_frames():
    sp = st.StressParams(gain_amp=0.2, gain_period=10.0)
    means = [float(st.render_stressed_stereo(_cam(), np.eye(4), i, sp)[0].mean())
             for i in (0, 2, 5, 7)]
    assert max(means) - min(means) > 5.0


def test_occluder_disparity_consistent():
    """The occluder panel appears shifted by fx*b/z in the right view."""
    sp = st.StressParams(occluders=((0.5, 0.5, 0.1, 0.1, 2.0, 0.0),),
                         occluder_intensity=0.0)
    cam = _cam(256, 128)
    L, R = (a.numpy() for a in st.render_stressed_stereo(cam, np.eye(4), 0, sp))
    cL, cR = _pair("clean", i=0, w=256, h=128)
    row = 64
    dark_l = np.nonzero((L[row] == 0.0) & (cL[row] > 10))[0]
    dark_r = np.nonzero((R[row] == 0.0) & (cR[row] > 10))[0]
    disp = cam.left.fx * cam.baseline / 2.0
    assert len(dark_l) and len(dark_r)
    assert abs((np.median(dark_l) - np.median(dark_r)) - disp) < 2.0


def test_lowtex_span_reduces_contrast():
    sp = st.StressParams(lowtex_spans=((5.0, 40.0),), lowtex_strength=0.9)
    flat = st.render_stressed_stereo(_cam(), np.eye(4), 0, sp)[0].numpy()
    clean = _pair("clean", i=0)[0]
    assert flat[40:].std() < 0.55 * clean[40:].std()


def test_specular_differs_between_views():
    sp = st.StressParams(specular_amp=0.4)
    L, R = _pair("clean")
    Ls, Rs = (a.numpy() for a in st.render_stressed_stereo(_cam(), np.eye(4), 0, sp))
    dL, dR = np.abs(Ls - L), np.abs(Rs - R)
    assert dL.max() > 20 and dR.max() > 20
    assert np.abs(dL - dR).max() > 20


def test_stressed_sequence_frames():
    seq = st.StressedSequence(n_frames=3, width=128, height=64, stress="severe", device=CPU)
    jseq = jst.StressedSequence(n_frames=3, width=128, height=64, stress="severe")
    np.testing.assert_allclose(seq.poses_wc, jseq.poses_wc, atol=1e-4)
    L, R, T = seq.frame(2)
    np.testing.assert_array_equal(T, seq.poses_wc[2])
    jL, jR, _ = jseq.frame(2)
    # the same pose through both (the trajectories differ in the last bits)
    jL, jR = jst.render_stressed_stereo(jseq.cam, jnp.asarray(T), 2, jst.SEVERE)
    _assert_close_render(L.numpy(), np.asarray(jL))
    _assert_close_render(R.numpy(), np.asarray(jR))
    assert seq.stress is st.SEVERE and len(list(iter(seq))) == 3


def test_stressed_sequence_defaults_to_cuda():
    if torch.cuda.is_available():
        assert st.StressedSequence(n_frames=1, width=64, height=32).cam.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            st.StressedSequence(n_frames=1, width=64, height=32)


# ---------------------------------------------------------------------------
# the aliased corridor
# ---------------------------------------------------------------------------

def test_alias_period_renders_identical_places():
    """Views 24 m apart along the corridor are pixel-identical (but for the
    far wall, whose distance is not folded)."""
    seq = syn.SyntheticSequence(n_frames=2, width=128, height=64, alias_period=24.0,
                                device=CPU)
    T0 = np.eye(4, dtype=np.float32)
    T1 = T0.copy()
    T1[2, 3] = -24.0
    a = syn.render_stereo(seq.cam, T0, 24.0)[0].numpy()
    b = syn.render_stereo(seq.cam, T1, 24.0)[0].numpy()
    assert (np.abs(a - b) > 1.0).mean() < 0.02
    # without the fold the two places differ
    c = syn.render_stereo(seq.cam, T1)[0].numpy()
    assert (np.abs(a - c) > 1.0).mean() > 0.2


def test_alias_period_matches_jax():
    jseq = jsyn.SyntheticSequence(n_frames=30, width=256, height=128, step=0.8,
                                  alias_period=24.0)
    seq = syn.SyntheticSequence(n_frames=30, width=256, height=128, step=0.8,
                                alias_period=24.0, device=CPU)
    assert seq.alias_period == 24.0
    for i in (0, 29):
        T = jseq.poses_wc[i].copy()
        got = syn.render_stereo(seq.cam, T, 24.0)
        want = jsyn.render_stereo(jseq.cam, jnp.asarray(T), 24.0)
        # the far wall lies at z = 480 m, 20 periods: there the last bit of
        # the hit's z decides whether the fold gives ~0 or ~24 m, so its
        # pixels are left out (bounded by their share of the image)
        far = []
        for shift in (0.0, seq.cam.baseline):
            o, d, t = syn.raycast(torch.as_tensor(T), seq.cam.left.fx, seq.cam.left.cx,
                                  seq.cam.left.cy, shift, 256, 128)
            far.append(np.abs((o[None, None, 2] + t * d[..., 2]).numpy() - 480.0) < 1.0)
        for a, b, f in zip(got, want, far):
            assert f.mean() < 0.1
            d = np.abs(a.numpy() - np.asarray(b))[~f]
            assert d.mean() < 0.5
            assert (d > 100.0).mean() < 1e-3
    np.testing.assert_array_equal(seq.frame(3)[0].numpy(),
                                  syn.render_stereo(seq.cam, seq.poses_wc[3], 24.0)[0].numpy())
    # the fold is jnp.mod's: the exact remainder with the period's sign
    z = torch.tensor([-49.5, -24.0, -0.25, 0.0, 23.999, 24.0, 71.5], dtype=torch.float32)
    np.testing.assert_array_equal(syn.fold_mod(z, 24.0).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(z.numpy()), 24.0)))


# ---------------------------------------------------------------------------
# a stressed run through both trackers in lock step
# ---------------------------------------------------------------------------

def _pose_diff(A, B):
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    ca = -A[:3, :3].T @ A[:3, 3]
    cb = -B[:3, :3].T @ B[:3, 3]
    D = A[:3, :3] @ B[:3, :3].T
    w = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.linalg.norm(ca - cb)), float(np.arcsin(min(1.0, np.linalg.norm(w))))


LOCK_CAP = 256
LOCK_COUNT_TOL = LOCK_CAP // 100
LOCK_POS_M, LOCK_ROT_RAD = 2e-2, 2e-3


def test_dense_field_differs_only_by_the_blur():
    """F13 on one stressed 8-bit frame: the two packages' dense fields
    differ in a few % of words, and not at all when both describe the JAX
    package's blurred image."""
    from svi_mapper_tpu.ops import descriptors as jd
    from svi_mapper_tpu.ops.image import box_blur as j_blur
    from svi_mapper_tpu_torch.ops import descriptors as td

    L = np.asarray(jst.StressedSequence(n_frames=2, width=256, height=128,
                                        stress="moderate").frame(1)[0])
    assert np.array_equal(L, np.round(L))             # 8-bit values
    want = np.asarray(jd.brief_dense(j_blur(jnp.asarray(L), 5)))
    got = td.words_to_numpy(td.smooth_brief_dense(torch.from_numpy(L.copy())))
    assert 0.0 < (got != want).mean() < 0.08
    blurred = torch.from_numpy(np.array(j_blur(jnp.asarray(L), 5)))
    np.testing.assert_array_equal(td.words_to_numpy(td.brief_dense(blurred)), want)


def test_stressed_lockstep():
    """16 frames of the moderate preset at 256 x 128 (rendered by the JAX
    package): the port's frame step from the JAX tracker's state before
    every frame, within the bounds stated at the top of this file."""
    kw = dict(max_landmarks=LOCK_CAP, max_detections=LOCK_CAP)
    jseq = jst.StressedSequence(n_frames=16, width=256, height=128, step=0.4,
                                stress="moderate")
    jt = JTracker(jseq.cam, dataclasses.replace(JPARAMS, **kw))
    cam = torch_camera(jseq.cam)
    params = dataclasses.replace(DEFAULT_PARAMS, **kw)
    tracked = []
    for i in range(16):
        L, R, _ = jseq.frame(i)
        L, R = np.asarray(L), np.asarray(R)
        state_in = torch_state(jt.state)
        a = jt.process(L, R)
        _, b = frame_mod.process_frame(state_in, L, R, cam, params, device=CPU)
        b = b.to_host()
        assert bool(a.posit_ok) == bool(b.posit_ok), i
        assert bool(a.is_keyframe) == bool(b.is_keyframe), i
        assert int(a.instability) == int(b.instability), i
        for name in ("n_tracked", "inliers"):
            assert abs(int(getattr(a, name)) - int(getattr(b, name))) <= LOCK_COUNT_TOL, \
                (i, name)
        dpos, drot = _pose_diff(a.T_wc, b.T_wc)
        assert dpos < LOCK_POS_M and drot < LOCK_ROT_RAD, (i, dpos, drot)
        tracked.append(int(b.n_tracked))
    assert min(tracked[5:]) >= 40
