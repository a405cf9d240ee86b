"""The generator: the same seed gives the same segments, another seed
other draws of the same sizes."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import manifest
from portbench.segments import make_ring
from portbench.tests.helpers import BIG_SEED, CELLS, small_traffic


def _ring(cell, seed, **kw):
    c = manifest.cell(manifest.load(), cell)
    return make_ring(small_traffic(cell, **kw), c["config"], seed, "cpu")


def _fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_segments(cell):
    a, b = _ring(cell, BIG_SEED), _ring(cell, BIG_SEED)
    for pa, pb in zip(a, b):
        for name, ta in _fields(pa).items():
            tb = _fields(pb)[name]
            assert (ta is None) == (tb is None)
            if ta is not None:
                assert torch.equal(ta, tb), name


@pytest.mark.parametrize("cell", CELLS)
def test_another_seed_other_draws_same_sizes(cell):
    a, b = _ring(cell, BIG_SEED)[0], _ring(cell, BIG_SEED + 1)[0]
    for name, ta in _fields(a).items():
        if ta is not None:
            assert ta.shape == _fields(b)[name].shape and ta.dtype == _fields(b)[name].dtype
    assert not torch.equal(a.X, b.X)
    assert (a.grav_d is None) == (cell == "kitti00-sv.segment-ba")


def test_segments_look_like_the_traffic_says():
    p = _ring(CELLS[0], 7, keyframes=32, landmarks=2048, ring=1)[0]
    per_landmark = p.mask.sum(0).float()
    assert 6 < float(per_landmark.mean()) < 14        # ~11 keyframes a landmark
    assert bool(p.fix[0]) and not bool(p.fix[1:].any())
    assert float(p.odo_w[:-1].min()) > 0 and float(p.odo_w[-1]) == 0
    step = (p.odo_M[:-1, :3, 3].norm(dim=-1))
    assert float((step - 5.0).abs().max()) < 0.5       # 5 m between keyframes
    obs = p.obs[p.mask]
    assert float(obs[:, 0].min()) > -3 and float(obs[:, 0].max()) < 1244
