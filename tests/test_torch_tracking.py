"""Port vs JAX package: window scoring, band parameters, track_landmarks.

``window_scores`` is all-integer and must agree EXACTLY with the JAX
``window_scores`` for every landmark, and with the Pallas ``track_scores``
(interpret mode) on in-view landmarks, ties included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from svi_mapper_tpu.frontend import epipolar as jepi
from svi_mapper_tpu.frontend import tracking as jtracking
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.models.tracker import StereoTracker as JTracker
from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.ops import track_kernel as jtk
from svi_mapper_tpu.ops.descriptors import smooth_brief_dense as jsmooth
from svi_mapper_tpu_torch.frontend import epipolar as epi
from svi_mapper_tpu_torch.frontend import tracking
from svi_mapper_tpu_torch.ops import track_kernel as tk

from torch_parity import t32, tint, torch_camera, torch_table, unwords, words

CUTS = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)


def _random_band(rng, L):
    theta = rng.uniform(0, 2 * np.pi, L)
    return (np.round(np.cos(theta) * 256).astype(np.int32),
            np.round(np.sin(theta) * 256).astype(np.int32),
            rng.integers(-800, 800, L).astype(np.int32),
            rng.integers(5, tk.REACH_X + 1, L).astype(np.int32),
            rng.integers(5, tk.REACH_Y + 1, L).astype(np.int32))


def _random_case(rng, h=128, w=256, L=48, planted=24, ties=8, border=29):
    """Random field + landmarks. The first ``planted`` landmarks get a
    near-exact match planted in their window; ``ties`` of them get a SECOND
    identical plant so the row-major tie rule decides."""
    dense = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(border, w - 1 - border, L),
                   rng.uniform(border, h - 1 - border, L)], 1).astype(np.float32)
    dlast = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
    dref = dlast.copy()
    for i in range(planted):
        d = dlast[i].copy()
        d[0] ^= np.uint32(0b111)
        for _ in range(2 if i < ties else 1):
            # even rows inside the stage-2 square (accepted under any band),
            # odd rows anywhere on the horizontal strip (stage 3 decides)
            reach = 8 if i % 2 == 0 else tk.REACH_X
            dx = int(rng.integers(-reach, reach + 1))
            dy = int(rng.integers(-2, 3))
            x = int(np.clip(round(float(uv[i, 0])) + dx, 0, w - 1))
            y = int(np.clip(round(float(uv[i, 1])) + dy, 0, h - 1))
            dense[y, x] = d
    return dense, uv, dlast, dref


def _fixed_band(L):
    return tuple(np.asarray(a) for a in jepi.fixed_band_params(
        L, tk.REACH_X, tk.REACH_Y))


def _both(dense, uv, dlast, dref, band):
    got = tk.window_scores(words(dense), t32(uv), words(dlast), words(dref),
                           tuple(tint(b) for b in band), **CUTS)
    want = jtracking.window_scores(
        jnp.asarray(dense), jnp.asarray(uv), jnp.asarray(dlast),
        jnp.asarray(dref), tuple(jnp.asarray(b) for b in band), **CUTS)
    return [g.numpy() for g in got], [np.asarray(v) for v in want]


def test_constants_match():
    for name in ("REACH_X", "REACH_Y", "WIN_W", "WIN_H", "BIG"):
        assert getattr(tk, name) == getattr(jtk, name)
    assert tk.BAND_HALF_WIDTH_Q == jepi.BAND_HALF_WIDTH_Q
    assert tk.BAND_SCALE == jepi.BAND_SCALE
    assert tk.TIER_BIAS == jtracking.TIER_BIAS
    for a, b in zip(epi.fixed_band_params(5, 28, 20), jepi.fixed_band_params(5, 28, 20)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,oriented", [(0, False), (1, True), (2, True)])
def test_window_scores_exact_vs_jax(seed, oriented):
    rng = np.random.default_rng(seed)
    L = 48
    band = _random_band(rng, L) if oriented else _fixed_band(L)
    got, want = _both(*_random_case(rng, L=L), band)
    assert int((want[0] < tk.BIG).sum()) >= 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)      # every landmark, all fields


def test_window_scores_exact_at_borders_and_nonfinite(rng):
    """Predictions on/over the image edge and NaN/inf predictions: the
    window clamps and the plain versions still agree everywhere."""
    L = 40
    dense, uv, dlast, dref = _random_case(rng, L=L, planted=16, border=0)
    uv[:8] = [[0, 0], [255, 127], [-30, 50], [300, 60], [100, -9], [100, 500],
              [np.nan, 5], [np.inf, -np.inf]]
    got, want = _both(dense, uv, dlast, dref, _random_band(rng, L))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_window_scores_vs_pallas_interpret(rng):
    """Against the TPU kernel run in interpret mode: equal on in-view
    landmarks (the 28 px inset its aligned blocks rely on), ties included."""
    L = 48
    dense, uv, dlast, dref = _random_case(rng, L=L)
    band = _random_band(rng, L)
    got, _ = _both(dense, uv, dlast, dref, band)
    kern = jtk.track_scores(
        jnp.asarray(dense), jnp.asarray(uv), jnp.asarray(dlast),
        jnp.asarray(dref), tuple(jnp.asarray(b) for b in band),
        interpret=True, **CUTS)
    kern = [np.asarray(v) for v in kern]
    np.testing.assert_array_equal(got[0], kern[0])
    acc = got[0] < tk.BIG
    assert int(acc.sum()) >= 10
    for g, k in zip(got[1:], kern[1:]):
        np.testing.assert_array_equal(g[acc], k[acc])


def test_track_scores_cpu_tensor_takes_plain_version(rng):
    dense, uv, dlast, dref = _random_case(rng, L=16, planted=8)
    band = tuple(tint(b) for b in _fixed_band(16))
    before = tk.track_scores_launches
    a = tk.track_scores(words(dense), t32(uv), words(dlast), words(dref), band, **CUTS)
    b = tk.window_scores(words(dense), t32(uv), words(dlast), words(dref), band, **CUTS)
    assert tk.track_scores_launches == before      # no launch on the CPU
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# --- a real tracking state: a few frames of the JAX tracker ---------------

@pytest.fixture(scope="module")
def live():
    seq = SyntheticSequence(n_frames=5, width=512, height=256, step=0.5)
    params = dataclasses.replace(JPARAMS, max_landmarks=384, max_detections=384)
    tr = JTracker(seq.cam, params)
    frames = [(np.asarray(l), np.asarray(r), T) for l, r, T in seq]
    for l, r, _ in frames[:4]:
        tr.process(l, r)
    l, r, T = frames[4]
    return dict(cam=seq.cam, table=tr.state.table, T_prior=np.asarray(T),
                dense_l=jsmooth(jnp.asarray(l)), dense_r=jsmooth(jnp.asarray(r)))


def test_motion_scaling_matches(rng):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.2, -0.1, 0.7]
    c, s = np.cos(0.03), np.sin(0.03)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    np.testing.assert_allclose(float(epi.motion_scaling(t32(T))),
                               float(jepi.motion_scaling(jnp.asarray(T))), rtol=1e-5)
    T[:3, 3] = [9, 9, 9]
    assert float(epi.motion_scaling(t32(T))) == 5.0


def test_epipolar_band_params_equal_integers(live):
    """Equal integers; a parameter may differ by 1 only where its float
    value lies within 1e-3 of a rounding boundary (x.5) — the test counts
    such rows and bounds them."""
    jt = live["table"]
    cam = torch_camera(live["cam"])
    tt = torch_table(jt)
    T = live["T_prior"]
    import svi_mapper_tpu.geometry.se3 as jse3
    uv_pred = live["cam"].left.project(jse3.transform(jnp.asarray(T), jt.pos_w))
    want = jepi.epipolar_band_params(
        jt, jnp.asarray(T), live["cam"].left, uv_pred, 1.7,
        reach_x=tk.REACH_X, reach_y=tk.REACH_Y)
    got = epi.epipolar_band_params(
        tt, t32(T), cam.left, t32(np.asarray(uv_pred)), 1.7,
        reach_x=tk.REACH_X, reach_y=tk.REACH_Y)
    active = np.asarray(jt.active)
    assert active.sum() > 100
    off_by_one = 0
    for g, w in zip(got, want):
        g, w = g.numpy()[active], np.asarray(w)[active]
        d = np.abs(g.astype(np.int64) - w)
        assert d.max() <= 1
        off_by_one += int((d == 1).sum())
    # found: 0 of ~380 rows x 5 parameters. A value sits within 1e-3 of a
    # rounding boundary with probability 2e-3 per parameter; allow 1 % of rows
    assert off_by_one <= max(2, int(0.01 * active.sum()))


def test_track_landmarks_same_matches(live):
    jt = live["table"]
    cam = torch_camera(live["cam"])
    T = live["T_prior"]
    want = jtracking.track_landmarks(
        live["dense_l"], live["dense_r"], jt, jnp.asarray(T), live["cam"], 1.3,
        use_desc_history=False)
    got = tracking.track_landmarks(
        words(live["dense_l"]), words(live["dense_r"]), torch_table(jt),
        t32(T), cam, 1.3, use_desc_history=False)
    tracked = np.asarray(want.tracked)
    assert tracked.sum() > 100
    # a band parameter off by one or a prediction on a .5 boundary can flip
    # a borderline landmark: at most 1 % of the rows (found: 0)
    flipped = got.tracked.numpy() != tracked
    assert flipped.sum() <= 0.01 * tracked.size
    tracked = tracked & ~flipped
    np.testing.assert_array_equal(got.tier.numpy()[tracked], np.asarray(want.tier)[tracked])
    np.testing.assert_array_equal(got.distance.numpy()[tracked],
                                  np.asarray(want.distance)[tracked])
    np.testing.assert_array_equal(unwords(got.desc_left)[tracked],
                                  np.asarray(want.desc_left)[tracked])
    # sub-pixel carry and the stereo parabola are float32 on both sides
    np.testing.assert_allclose(got.uv4.numpy()[tracked], np.asarray(want.uv4)[tracked],
                               atol=1e-3)
    np.testing.assert_allclose(got.depth.numpy()[tracked], np.asarray(want.depth)[tracked],
                               rtol=1e-4)


def test_track_landmarks_history_anchor_and_fixed_band(live):
    jt = live["table"]
    cam = torch_camera(live["cam"])
    T = live["T_prior"]
    for kw in (dict(use_desc_history=True), dict(use_epipolar=False, use_desc_history=False)):
        want = jtracking.track_landmarks(
            live["dense_l"], live["dense_r"], jt, jnp.asarray(T), live["cam"], 1.0, **kw)
        got = tracking.track_landmarks(
            words(live["dense_l"]), words(live["dense_r"]), torch_table(jt),
            t32(T), cam, 1.0, **kw)
        flipped = got.tracked.numpy() != np.asarray(want.tracked)
        assert flipped.sum() <= 0.01 * flipped.size
        m = np.asarray(want.tracked) & ~flipped
        np.testing.assert_array_equal(got.tier.numpy()[m], np.asarray(want.tier)[m])
