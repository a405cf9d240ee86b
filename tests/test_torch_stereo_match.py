"""K2's fused scanline match on the CPU: ``ops.stereo_kernel.stereo_match_plain``
(what ``match_stereo`` takes from the scanline search, and what the CUDA
kernel ``stereo_match_kernel`` is held to on the card) against the chain
``match_stereo`` ran before the search was fused (restated below) and
against the JAX package's ``frontend/stereo.py:match_stereo`` (its XLA
row-span branch), on the same numpy-seeded inputs.

``distance`` (the first masked minimum), ``ok`` and ``disparity`` are
compared exactly; depth, uv_right and the triangulated point to 1e-6
relative. Cases: keypoints with NaN and far coordinates (+-3e9, +-1e20),
on exact halves, planted ties in the profile, a search range that masks
every candidate, an image narrower than ``max_disparity``, with and
without ``disparity_center``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.frontend.stereo import match_stereo as jmatch
from svi_mapper_tpu.io.synthetic import SyntheticSequence, default_camera
from svi_mapper_tpu.ops.descriptors import brief_at as jbrief_at
from svi_mapper_tpu.ops.descriptors import smooth_brief_dense as jsmooth
from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.ops import stereo_kernel as sk

from torch_parity import t32, tbool, torch_camera, words

_BIG = 1 << 20
FAR = [[3e9, 40.0], [-3e9, 41.0], [1e20, 42.0], [-1e20, 43.0],
       [60.0, 3e9], [61.0, -3e9], [62.0, 1e20], [63.0, -1e20],
       [np.nan, 44.0], [70.0, np.nan], [np.nan, np.nan]]


def chain_before(dense_right, uv_left, desc_left, valid, cam, *, max_disparity=128,
                 cutoff=100, min_disparity=0.5, min_depth=0.05, max_depth=1000.0,
                 disparity_center=None, search_range=None):
    """``match_stereo`` as it was before the search was fused: the profile,
    the disparity grid, the masks, the first minimum and three gathers in
    PyTorch."""
    K = uv_left.shape[0]
    dt, dev = uv_left.dtype, uv_left.device
    dist, u_r, x0 = sk.stereo_profiles(dense_right, uv_left, desc_left,
                                       max_disparity=max_disparity)
    De = dist.shape[1]
    base = (u_r - x0 - (De - 1)).to(dt)
    disps = base[:, None] + torch.arange(De, dtype=dt, device=dev)[None, :]
    okc = (disps >= min_disparity) & (disps <= uv_left[:, 0:1]) & (disps <= De - 1)
    if disparity_center is not None:
        rng = (search_range if search_range is not None
               else torch.full((K,), 60.0, dtype=dt, device=dev))
        okc = okc & (torch.abs(disps - disparity_center[:, None]) <= rng[:, None])
    dist = torch.where(okc, dist, torch.full_like(dist, _BIG))
    best_dist, best = torch.min(dist, dim=1)
    disparity = torch.gather(disps, 1, best[:, None])[:, 0]
    S = De
    dm = torch.gather(dist, 1, torch.clamp(best - 1, 0, S - 1)[:, None])[:, 0]
    dp = torch.gather(dist, 1, torch.clamp(best + 1, 0, S - 1)[:, None])[:, 0]
    denom = (dm + dp - 2 * best_dist).to(dt)
    interior = (best > 0) & (best < S - 1)
    delta = torch.where(interior & (denom > 0) & (dm < _BIG) & (dp < _BIG),
                        0.5 * (dm - dp).to(dt) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    disparity = disparity + torch.clamp(delta, -0.5, 0.5)
    depth = cam.depth_from_disparity(disparity)
    uv_right = torch.stack([uv_left[:, 0] - disparity, uv_left[:, 1]], dim=-1)
    ok = (valid & (best_dist <= cutoff) & (disparity >= min_disparity)
          & (depth > min_depth) & (depth < max_depth))
    rows = torch.stack([best.to(torch.int32), best_dist, dm, dp, u_r, x0])
    return dict(distance=best_dist, ok=ok, disparity=disparity, depth=depth,
                uv_right=uv_right, p_cam=cam.triangulate(uv_left, uv_right), rows=rows)


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(n_frames=1, width=512, height=256, step=0.8)
    l, r, _ = seq.frame(0)
    return seq.cam, jsmooth(jnp.asarray(l)), jsmooth(jnp.asarray(r))


def _check(jcam, dense_r, uv, desc, valid=None, n_ok=0, **kw):
    """All three against one another; returns the plain version's rows."""
    K = uv.shape[0]
    valid = np.ones(K, bool) if valid is None else valid
    tkw = {k: (t32(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    search = {k: tkw[k] for k in ("disparity_center", "search_range", "min_disparity",
                                  "max_disparity") if k in tkw}
    rows = sk.stereo_match_plain(words(dense_r), t32(uv), words(desc), **search)
    # the CPU dispatch of the wrapper is the plain version, launching nothing
    n0 = sk.stereo_match_launches
    assert torch.equal(sk.stereo_match(words(dense_r), t32(uv), words(desc), **search), rows)
    assert sk.stereo_match_launches == n0
    tcam = torch_camera(jcam)
    got = match_stereo(words(dense_r), t32(uv), words(desc), tbool(valid), tcam, **tkw)
    old = chain_before(words(dense_r), t32(uv), words(desc), tbool(valid), tcam, **tkw)
    want = jmatch(jnp.asarray(dense_r), jnp.asarray(uv), jnp.asarray(desc),
                  jnp.asarray(valid), jcam, force_kernel=False, **jkw)
    assert torch.equal(rows, old["rows"])
    for name in ("distance", "ok", "disparity", "depth", "uv_right", "p_cam"):
        # bit for bit; NaN where the chain gave NaN
        torch.testing.assert_close(getattr(got, name), old[name], rtol=0, atol=0,
                                   equal_nan=True, msg=name)
    ok = np.asarray(want.ok)
    assert int(ok.sum()) >= n_ok
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))
    np.testing.assert_array_equal(got.disparity.numpy(), np.asarray(want.disparity))
    for name in ("depth", "uv_right", "p_cam"):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok],
                                   np.asarray(getattr(want, name))[ok], rtol=1e-6, atol=0)
    return rows


def _scene_keypoints(rng, K, lo=0.0):
    return np.stack([rng.uniform(lo, 511, K), rng.uniform(0, 255, K)], 1).astype(np.float32)


CASES = ["unbounded", "nan_and_far", "half_pixel", "centre_and_range",
         "centre_default_range", "range_masks_everything", "floor_and_cap"]


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_chain_before_and_jax(scene, rng, case):
    jcam, dense_l, dense_r = scene
    K = 160
    uv = _scene_keypoints(rng, K)
    kw, n_ok = {}, 30
    if case == "nan_and_far":
        uv[:len(FAR)] = FAR
    elif case == "half_pixel":
        uv = np.floor(uv) + 0.5
    elif case == "centre_and_range":
        kw = dict(disparity_center=rng.uniform(-5, 60, K).astype(np.float32),
                  search_range=rng.uniform(0, 40, K).astype(np.float32))
        kw["search_range"][::5] = np.round(kw["search_range"][::5])
        n_ok = 5
    elif case == "centre_default_range":
        kw = dict(disparity_center=rng.uniform(-5, 60, K).astype(np.float32))
    elif case == "range_masks_everything":
        kw = dict(disparity_center=np.full(K, -1000.0, np.float32),
                  search_range=np.full(K, 30.0, np.float32))
        n_ok = 0
    elif case == "floor_and_cap":
        kw = dict(max_disparity=48, min_disparity=3.7)
        n_ok = 10
    desc = np.asarray(jbrief_at(dense_l, jnp.asarray(np.nan_to_num(uv, nan=0.0))))
    valid = rng.integers(0, 6, K) > 0
    rows = _check(jcam, np.asarray(dense_r), uv, desc, valid, n_ok, **kw)
    if case == "nan_and_far":
        # NaN in u masks every candidate; the far keypoints read the edge
        assert (rows[1, [8, 10]] == _BIG).all()
    if case == "range_masks_everything":
        assert (rows[0] == 0).all() and (rows[1:4] == _BIG).all()


def test_planted_ties_go_to_the_lower_index(rng):
    """On a random field the same pixel is written at two candidates of a
    keypoint's span and the descriptor lies a few bits from it: the lower
    index (the smaller disparity) wins, in all three."""
    h, w, K, De = 80, 240, 64, 128
    jcam = default_camera(w, h)
    dense_r = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(De, w - 1, K), rng.choice(h, K, replace=False)], 1)
    uv = uv.astype(np.float32)
    u = np.clip(np.round(uv[:, 0]), 0, w - 1).astype(int)
    v = uv[:, 1].astype(int)
    x0 = np.clip(u - (De - 1), 0, w - De)
    i1 = rng.integers(1, De - 30, K)
    i2 = i1 + rng.integers(1, 25, K)
    px = dense_r[v, x0 + (De - 1) - i1]
    dense_r[v, x0 + (De - 1) - i2] = px
    flips = rng.integers(0, 12, K)
    desc = px.copy()
    for k in range(K):
        for b in range(flips[k]):
            desc[k, b // 32] ^= np.uint32(1 << (b % 32))
    rows = _check(jcam, dense_r, uv, desc, n_ok=K // 2)
    np.testing.assert_array_equal(rows[0].numpy(), i1)
    np.testing.assert_array_equal(rows[1].numpy(), flips)


@pytest.mark.parametrize("centre", [False, True])
def test_image_narrower_than_max_disparity(rng, centre):
    """W = 96 < max_disparity = 128: the span is the whole row."""
    h, w, K = 64, 96, 48
    jcam = default_camera(w, h)
    dense_r = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(0, w - 1, K), rng.uniform(0, h - 1, K)], 1).astype(np.float32)
    d_true = rng.integers(1, 40, K)
    desc = np.zeros((K, 8), np.uint32)
    for k in range(K):
        x = int(np.clip(round(float(uv[k, 0])) - d_true[k], 0, w - 1))
        desc[k] = dense_r[int(round(float(uv[k, 1]))), x]
    kw = dict(disparity_center=(d_true + rng.uniform(-3, 3, K)).astype(np.float32),
              search_range=np.full(K, 5.0, np.float32)) if centre else {}
    rows = _check(jcam, dense_r, uv, desc, n_ok=20, **kw)
    assert rows.shape == (6, K) and int(rows[5].max()) == 0


@pytest.mark.gpu
def test_match_kernel_equals_plain_version_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, K = 64, 300, 200
    dense_r = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(-5, w + 5, K), rng.uniform(0, h - 1, K)], 1).astype(np.float32)
    uv[:len(FAR)] = FAR
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    center = rng.uniform(0, 128, K).astype(np.float32)
    for kw in ({}, dict(disparity_center=t32(center))):
        n0 = sk.stereo_match_launches
        got = sk.stereo_match(words(dense_r).cuda(), t32(uv).cuda(), words(desc).cuda(),
                              **{k: v.cuda() for k, v in kw.items()})
        assert sk.stereo_match_launches == n0 + 1
        want = sk.stereo_match_plain(words(dense_r), t32(uv), words(desc), **kw)
        assert torch.equal(got.cpu(), want)
