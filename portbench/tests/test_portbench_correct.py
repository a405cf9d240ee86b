"""What decides ``correct``: the port's ``bundle_adjust`` against the plain
reference, the control (the reference in TF32) failing the limits, and a
run with the timed path broken underneath coming out not correct."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import manifest
from portbench import run as bench_run
from portbench import study
from portbench.reference.compare import over_limits
from portbench.tests.helpers import BIG_SEED, CELLS, limits, small_traffic


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference_on_the_materialised_route(cell):
    """K = 4 x L = 64 on the CPU (the route without the kernels): every
    answer within the cell's limits."""
    result, checks = bench_run.run_cell(cell, BIG_SEED, 0.5, False, torch.device("cpu"),
                                        traffic=small_traffic(cell))
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert checks["iterations_gap"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 5, 8])
def test_control_fails_and_program_passes_on_the_cpu(cell, seed):
    """The reference in TF32 at K = 32 x L = 2048 fails a limit on every
    segment; the program passes them all."""
    lim = limits(cell)
    rows = study.readings(cell, seed, torch.device("cpu"), True,
                          small_traffic(cell, keyframes=32, landmarks=2048, ring=1))
    for r in rows:
        if r["side"] == "control":
            assert over_limits(r, lim), r
        else:
            assert not over_limits(r, lim), r


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(cell):
    """On the card, at the cell's own size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lim = limits(cell)
    for seed in (31, 32, 33):
        for r in study.readings(cell, seed, torch.device("cuda", 0), True):
            assert bool(over_limits(r, lim)) == (r["side"] == "control"), r


def _unchanged(real, T, X, *a, **kw):
    res = real(T, X, *a, **kw)
    return dataclasses.replace(res, T_wc=T.clone(), points_w=X.clone(),
                               chi2_final=res.chi2_initial)


def _half_batch(real, T, X, obs, mask, *a, **kw):
    kept = mask.clone()
    kept[:, mask.shape[1] // 2:] = False
    return real(T, X, obs, kept, *a, **kw)


def _answer_altered(real, *a, **kw):
    res = real(*a, **kw)
    T = res.T_wc.clone()
    T[-1, 0, 3] += 0.1
    return dataclasses.replace(res, T_wc=T)


def _answer_nan(real, *a, **kw):
    res = real(*a, **kw)
    return dataclasses.replace(res, points_w=res.points_w * float("nan"))


def _gravity_flipped(real, *a, **kw):
    return real(*a, **{**kw, "grav_d": -kw["grav_d"]})


FAULTS = {"state_unchanged": _unchanged, "half_the_landmarks": _half_batch,
          "answer_altered": _answer_altered, "answer_nan": _answer_nan,
          "gravity_flipped": _gravity_flipped}
# the gravity fault only where the configuration has gravity terms
BROKEN = [(n, c) for n in FAULTS for c in CELLS if n != "gravity_flipped" or c == CELLS[1]]


@pytest.mark.parametrize("name,cell", BROKEN, ids=[f"{n}-{c}" for n, c in BROKEN])
def test_a_broken_timed_path_is_not_correct(name, cell, monkeypatch):
    from svi_mapper_tpu_torch.solvers import ba

    real = ba.bundle_adjust
    fault = FAULTS[name]
    monkeypatch.setattr(ba, "bundle_adjust", lambda *a, **kw: fault(real, *a, **kw))
    result, checks = bench_run.run_cell(cell, BIG_SEED + 1, 0.3, False, torch.device("cpu"),
                                        traffic=small_traffic(cell))
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_timed_call_carries_the_configurations_terms(cell, monkeypatch):
    """Every solve of the window hands the program the pose chain and, in
    the stereo-inertial configuration, one gravity unary a keyframe at the
    configuration's weight, with unit down directions."""
    from svi_mapper_tpu_torch.solvers import ba

    real, calls = ba.bundle_adjust, []

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ba, "bundle_adjust", spy)
    traffic = small_traffic(cell)
    result, _ = bench_run.run_cell(cell, BIG_SEED + 2, 0.3, False, torch.device("cpu"),
                                   traffic=traffic)
    K = traffic["keyframes"]
    gravity = manifest.cell(manifest.load(), cell)["config"].get("gravity")
    assert len(calls) >= result["attempted"] + traffic["ring"]
    for kw in calls:
        assert kw["use_schur_kernel"] is None
        assert kw["odo_w"].shape == (K,) and bool((kw["odo_w"][:-1] > 0).all())
        if gravity is None:
            assert kw["grav_d"] is None and kw["grav_w"] is None
        else:
            assert kw["grav_w"].shape == (K,)
            assert bool((kw["grav_w"] == gravity["weight"]).all())
            norms = kw["grav_d"].double().norm(dim=-1)
            assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)

