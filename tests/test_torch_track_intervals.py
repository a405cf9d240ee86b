"""K1's listing of the window pixels a tier can accept
(``ops/track_kernel.py:tier_row_intervals``, restated by
``csrc/track_scores.cu``), by hypothesis; and the inputs the main path hands
K1, held to what the kernel takes.

The kernel scores only the listed pixels and folds window position 0 into
its min. Here, on the CPU: the listing is exactly the set of pixels where
the region part of ``tier_scores`` accepts (so within the union plus no
column at a row's ends), for band parameters of both signs and zero,
windows clamped at all four image edges, any reach; and a plain evaluation
over the listed pixels plus the first unlisted position — or plus position
0, the kernel's rule — gives ``window_scores`` for every landmark.
"""

import dataclasses

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.frontend import tracking
from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
from svi_mapper_tpu_torch.models.tracker import StereoTracker
from svi_mapper_tpu_torch.ops import track_kernel as tk
from svi_mapper_tpu_torch.ops.descriptors import hamming_words

CUTS = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)


@st.composite
def cases(draw):
    """An image just larger than the window, and landmarks whose
    predictions lie inside, on and beyond every edge, with bands of every
    sign (zeros included) and reach."""
    h = draw(st.integers(tk.WIN_H, tk.WIN_H + 40))
    w = draw(st.integers(tk.WIN_W, tk.WIN_W + 60))
    L = draw(st.integers(1, 12))

    def coord(n):
        return st.one_of(st.floats(-60.0, n + 60.0, width=32),
                         st.sampled_from([0.0, n - 1.0, -0.5, n - 0.5, 3.5]))

    lm = st.tuples(coord(w), coord(h),
                   st.one_of(st.integers(-256, 256), st.just(0)),
                   st.one_of(st.integers(-256, 256), st.just(0)),
                   st.integers(-3000, 3000),
                   st.integers(1, tk.REACH_X), st.integers(1, tk.REACH_Y))
    rows = draw(st.lists(lm, min_size=L, max_size=L))
    seed = draw(st.integers(0, 2 ** 16))
    uv = torch.tensor([r[:2] for r in rows], dtype=torch.float32)
    band = torch.tensor([r[2:] for r in rows], dtype=torch.int32).T.contiguous()
    return h, w, uv, band, seed


def _window_grids(origin):
    u_r, v_r, x0, y0 = origin
    col = torch.arange(tk.WIN_W, dtype=torch.int32)
    row = torch.arange(tk.WIN_H, dtype=torch.int32)
    dx = (x0[:, None, None] + col[None, None, :]) - u_r[:, None, None]
    dy = (y0[:, None, None] + row[None, :, None]) - v_r[:, None, None]
    return dx, dy


def _region(origin, band):
    """[L, WIN_H, WIN_W]: where the region part of ``tier_scores`` accepts
    (a zero distance and an open anchor gate pass every cutoff)."""
    dx, dy = _window_grids(origin)
    zero = torch.zeros_like(dx)
    nxq, nyq, c0q, ru, rv = (b[:, None, None] for b in band)
    s = tk.tier_scores(dx, dy, zero, torch.ones_like(dx, dtype=torch.bool),
                       nxq, nyq, c0q, ru, rv, 0, 0)
    return s < 4096


@settings(max_examples=150, deadline=None)
@given(cases())
def test_listing_is_exactly_where_a_tier_region_accepts(case):
    h, w, uv, band, _ = case
    origin = tk.window_origin(uv, h, w)
    lo, hi = tk.tier_row_intervals(*origin, band)
    listed = tk.listed_mask(lo, hi)
    region = _region(origin, band)
    # every accepting pixel is listed ...
    assert not bool((region & ~listed).any())
    # ... and nothing else: within the union plus one column at each end of
    # a row's intervals, and in fact exactly the union
    assert int(listed.sum()) <= int(region.sum()) + 2 * 2 * region.shape[0] * tk.WIN_H
    assert torch.equal(listed, region)
    # at most two intervals per row, ordered pairs that do not touch
    both = (hi >= lo).all(-1)
    assert not bool((both & (lo[..., 1] <= hi[..., 0] + 1) & (lo[..., 0] <= hi[..., 1] + 1)).any())
    assert bool(((lo >= 0) | (hi < lo)).all()) and bool(((hi < tk.WIN_W) | (hi < lo)).all())


@settings(max_examples=60, deadline=None)
@given(cases())
def test_listed_pixels_plus_one_position_give_window_scores(case):
    """Scores over the listed pixels, plus the key of the first position the
    listing leaves out (or of position 0): equal to ``window_scores`` for
    every landmark, on a random field with matches planted near the
    predictions."""
    h, w, uv, band, seed = case
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (h, w, 8)).astype(np.int32))
    origin = tk.window_origin(uv, h, w)
    u_r, v_r, x0, y0 = origin
    L = uv.shape[0]
    # the last descriptor: a pixel of the window, a few bits off
    px = torch.from_numpy(rng.integers(0, tk.WIN_W, L).astype(np.int32)) + x0
    py = torch.from_numpy(rng.integers(0, tk.WIN_H, L).astype(np.int32)) + y0
    desc_ref = dense[py.long(), px.long()]
    flips = torch.from_numpy(rng.integers(0, 2, (L, 8)).astype(np.int32) << 7)
    desc_last = desc_ref ^ flips
    want = tk.window_scores(dense, uv, desc_last, desc_ref, band, **CUTS)

    dx, dy = _window_grids(origin)
    ys = (y0[:, None, None] + torch.arange(tk.WIN_H)[None, :, None]).long()
    xs = (x0[:, None, None] + torch.arange(tk.WIN_W)[None, None, :]).long()
    win = dense[ys, xs]
    d_last = hamming_words(win, desc_last[:, None, None, :])
    d_ref = hamming_words(win, desc_ref[:, None, None, :])
    nxq, nyq, c0q, ru, rv = (b[:, None, None] for b in band)
    score = tk.tier_scores(dx, dy, d_last, d_ref <= CUTS["cutoff_ref"], nxq, nyq, c0q,
                           ru, rv, CUTS["cutoff_s1"], CUTS["cutoff_s2"])
    pos = torch.arange(tk.WIN_H * tk.WIN_W, dtype=torch.int32).reshape(tk.WIN_H, tk.WIN_W)
    key = score * 4096 + pos
    listed = tk.listed_mask(*tk.tier_row_intervals(*origin, band))
    big = torch.iinfo(torch.int32).max
    over_listed = torch.where(listed, key, big).reshape(L, -1).amin(1)
    unlisted = (~listed).reshape(L, -1)
    # the first position the listing leaves out, where there is one
    q = torch.where(unlisted.any(1), unlisted.to(torch.int8).argmax(1),
                    torch.full((L,), -1)).to(torch.int32)
    with_q = torch.where(q >= 0, torch.minimum(over_listed, 4096 * 4096 + q), over_listed)
    with_0 = torch.minimum(over_listed, torch.full_like(over_listed, 4096 * 4096))
    for folded in (with_q, with_0):
        got = tk._decode_key(folded, x0, y0)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_main_path_hands_k1_what_the_kernel_takes(monkeypatch):
    """Three frames of the port's tracker on the CPU: every call of K1's
    wrapper from ``track_landmarks`` passes the checks the card applies
    (one [5, L] int32 band, contiguous float32 predictions, aligned
    descriptors)."""
    calls = []
    real = tracking.track_scores

    def spy(*args, **kw):
        tk.check_track_inputs(*args)
        calls.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tracking, "track_scores", spy)
    seq = SyntheticSequence(n_frames=3, width=256, height=128, step=0.5, device="cpu")
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=128, max_detections=128)
    tracker = StereoTracker(seq.cam, params, device="cpu")
    for left, right, _ in seq:
        tracker.process(left, right)
    assert calls and all(n == 128 for n in calls)
