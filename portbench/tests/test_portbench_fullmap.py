"""The whole-map cell (``kitti00-sv-fullmap.global-ba``) on the CPU, at a
small circuit: the generator, the driver and what decides ``correct``, the
frozen work of ``portbench/work/obs_schur.py``, and the four readers of the
observation-list route's metrics on a made-up timeline."""

from __future__ import annotations

import ast
import copy
import dataclasses
import json

import pytest
import torch

from portbench import manifest
from portbench import run as bench_run
from portbench.circuit import make_ring, path
from portbench.record import Run, Solve
from portbench.tests.helpers import BIG_SEED
from portbench.tests.test_portbench_run import _Event, _trace
from portbench.trace import SOLVE, WINDOW
from portbench.work.obs_schur import bound_seconds, obs_schur_work

CELL = "kitti00-sv-fullmap.global-ba"
METRICS = ("obs_schur_roofline_pct.map", "pair_product_ms_per_iter.map",
           "cholesky_ms_per_iter.map", "obs_list_ms_per_solve.map")


def _config(K=136, L=1500):
    cfg = copy.deepcopy(manifest.cell(manifest.load(), CELL)["config"])
    cfg["map"].update(keyframes=K, landmarks=L)
    return cfg


def _bench(tmp_path, **sizes) -> dict:
    """``BENCHMARK.json`` with the cell's configuration at a small size, in
    a file of ``tmp_path``."""
    f = tmp_path / "config.json"
    f.write_text(json.dumps(_config(**sizes)))
    bench = copy.deepcopy(manifest.load())
    for c in bench["configs"]:
        if c["name"] == "kitti00-sv-fullmap":
            c["file"] = str(f)
    return bench


def _ring(seed, **sizes):
    return make_ring(manifest.cell(manifest.load(), CELL)["traffic"], _config(**sizes), seed,
                     "cpu")


# -- the generator -------------------------------------------------------------

def test_same_seed_same_maps_another_seed_other_draws():
    a, b, c = _ring(BIG_SEED, K=40, L=500), _ring(BIG_SEED, K=40, L=500), \
        _ring(BIG_SEED + 1, K=40, L=500)
    assert len(a) == 2
    for pa, pb, pc in zip(a, b, c):
        for f in dataclasses.fields(pa):
            ta, tb, tc = (getattr(x, f.name) for x in (pa, pb, pc))
            assert (ta is None) == (tb is None)
            if ta is not None:
                assert torch.equal(ta, tb), f.name
                assert ta.shape == tc.shape and ta.dtype == tc.dtype
        assert not torch.equal(pa.X, pc.X)


def test_the_circuit_closes_on_itself():
    """5 m between keyframes, the one after the last at the first, the
    heading turned by 2 pi; the last keyframes see the first keyframes'
    landmarks."""
    m = _config(K=200)["map"]
    g = torch.Generator().manual_seed(3)
    R_wc, centre = path(m, g, "cpu")
    step = (torch.roll(centre, -1, 0) - centre).norm(dim=-1)
    assert float((step - 5.0).abs().max()) < 0.1
    assert float(centre.norm(dim=-1).max()) > 200 / (2 * 3.1416) * 5 * 0.9
    p = _ring(7, K=200, L=4000)[0]
    assert int((p.mask[:6].any(0) & p.mask[-6:].any(0)).sum()) > 20
    per_landmark = p.mask.sum(0).float()
    assert 6 < float(per_landmark.mean()) < 14
    assert bool(p.fix[0]) and not bool(p.fix[1:].any())
    assert float(p.odo_w[:-1].min()) > 0 and float(p.odo_w[-1]) == 0
    # insertion order: a landmark's first observer grows along the table
    first = torch.where(p.mask.any(0), p.mask.float().argmax(0), 0)
    seen = p.mask.any(0) & (first > 10) & (first < 190)
    assert float(torch.corrcoef(torch.stack([torch.arange(4000.0)[seen],
                                             first[seen].float()]))[0, 1]) > 0.9


# -- the driver and correct ------------------------------------------------------

def test_small_cell_is_correct_on_the_list_route(tmp_path, capsys):
    bench = _bench(tmp_path)
    result, checks = bench_run.run_cell(CELL, BIG_SEED, 0.5, False, torch.device("cpu"),
                                        bench=bench)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and checks["iterations_gap"]["value"] == 0
    err = capsys.readouterr().err
    counts = ast.literal_eval(err.split("window program counts ")[1].splitlines()[0])
    assert counts["buffer_sets"] == 0 and counts["graph_capture"] == 0
    assert counts["solves"] == result["attempted"]


def _unchanged(real, T, X, *a, **kw):
    res = real(T, X, *a, **kw)
    return dataclasses.replace(res, T_wc=T.clone(), points_w=X.clone(),
                               chi2_final=res.chi2_initial)


def _pose_altered(real, *a, **kw):
    res = real(*a, **kw)
    T = res.T_wc.clone()
    T[-1, 0, 3] += 1.0
    return dataclasses.replace(res, T_wc=T)


def _loop_observations_dropped(real, T, X, obs, mask, *a, **kw):
    K = mask.shape[0]
    cut = mask.clone()
    cut[K // 2:, mask[: K // 4].any(0)] = False
    return real(T, X, obs, cut, *a, **kw)


@pytest.mark.parametrize("fault", [_unchanged, _pose_altered, _loop_observations_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    from svi_mapper_tpu_torch.solvers import ba

    real = ba.bundle_adjust
    monkeypatch.setattr(ba, "bundle_adjust", lambda *a, **kw: fault(real, *a, **kw))
    result, checks = bench_run.run_cell(CELL, BIG_SEED + 1, 0.3, False, torch.device("cpu"),
                                        bench=_bench(tmp_path))
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"] > 0


# -- the frozen work ---------------------------------------------------------------

def test_obs_schur_work_by_hand():
    mask = torch.tensor([[1, 1, 0], [1, 0, 0], [1, 1, 1]], dtype=torch.bool)
    w = obs_schur_work(mask, 3, 3)
    # landmarks seen 3, 2, 1 times: 6 observations, 6 + 3 + 1 co-visible blocks
    assert w["observations"] == 6 and w["pairs"] == 10
    assert w["flops"] == 6 * (555 + 90 + 36) + 216 * 10
    assert w["bytes"] == 4 * (16 * 3 + 3 * 3) + 28 * 6 + 8 * 10 + 4 * (36 * 9 + 18 + 36 + 18 * 6)
    assert bound_seconds(w) == max(w["flops"] / 67e12, w["bytes"] / 3.35e12)


# -- the readers ---------------------------------------------------------------------

def _run(events, iterations=2, solves=1):
    run = Run(config={}, traffic={}, seed=1)
    run.solves = [Solve(segment=0, latency_s=0.1, iterations=iterations)] * solves
    run.work["obs_schur"] = [dict(flops=67e12 * 2e-7, bytes=0)]      # 200 ns a bound
    run.trace = _trace(events)
    return run


def _events(with_route=True):
    """A window of one solve: the lists, then two iterations, each an
    assembly whose pair product launches one kernel, and a Cholesky."""
    ev = [_Event(WINDOW, 0, 10_000), _Event(SOLVE, 0, 10_000),
          _Event("svi.ba.solve", 10, 9_000, corr=1)]
    corr = 10
    if with_route:
        ev += [_Event("svi.ba.obs_list", 20, 400, corr=2), _Event("aten::nonzero", 30, 60, corr=3),
               _Event("nonzero_kernel", 100, 150, cuda=True, linked=3),
               _Event("Memcpy DtoH (Device -> Pageable)", 160, 170, cuda=True, linked=3)]
    for it, t0 in enumerate((1_000, 5_000)):
        ev += [_Event("svi.ba.iteration", t0, t0 + 3_000, corr=corr),
               _Event("svi.ba.assemble", t0 + 10, t0 + 1_000, corr=corr + 1),
               _Event("aten::mul", t0 + 20, t0 + 30, corr=corr + 2),
               _Event("mul_kernel", t0 + 100, t0 + 200, cuda=True, linked=corr + 2)]
        if with_route:
            ev += [_Event("svi.ba.pair_product", t0 + 500, t0 + 900, corr=corr + 3),
                   _Event("aten::bmm", t0 + 510, t0 + 520, corr=corr + 4),
                   _Event("gemm_kernel", t0 + 600, t0 + 900, cuda=True, linked=corr + 4)]
        ev += [_Event("aten::linalg_cholesky_ex", t0 + 1_100, t0 + 1_200, corr=corr + 5),
               _Event("potrf_kernel", t0 + 1_300, t0 + 1_700, cuda=True, linked=corr + 5)]
        corr += 10
    return ev


def test_the_route_readers_on_a_timeline():
    run = _run(_events())
    read = {m: manifest.reader(m)(run) for m in METRICS}
    # assembly kernels 2 x (100 + 300) ns against 2 x 200 ns of bound
    assert read["obs_schur_roofline_pct.map"] == pytest.approx(50.0)
    assert read["pair_product_ms_per_iter.map"] == pytest.approx(300e-6)
    assert read["cholesky_ms_per_iter.map"] == pytest.approx(400e-6)
    assert read["obs_list_ms_per_solve.map"] == pytest.approx(60e-6)


def test_the_route_readers_are_silent_without_the_route():
    """A program without the list route (the parent's materialised route at
    this size) has no ``svi.ba.obs_list`` / ``pair_product`` span: the
    three readers of the route are silent, the Cholesky's still reads."""
    run = _run(_events(with_route=False))
    read = {m: manifest.reader(m)(run) for m in METRICS}
    assert read["obs_schur_roofline_pct.map"] is None
    assert read["pair_product_ms_per_iter.map"] is None
    assert read["obs_list_ms_per_solve.map"] is None
    assert read["cholesky_ms_per_iter.map"] == pytest.approx(400e-6)
    untraced = Run(config={}, traffic={}, seed=1)
    assert all(manifest.reader(m)(untraced) is None for m in METRICS)
