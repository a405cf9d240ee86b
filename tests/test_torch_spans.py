"""The program's spans (``eval/timing.py:span``): off, they cost a shared
null context and keep nothing; under ``StageTimer.recording()`` the LM loop
of ``solvers/ba.py`` and the trackers' stages are kept in memory with their
parents and request ids; under a CPU ``torch.profiler`` they are host events
that ``portbench/spans.py`` reads from a ``portbench.trace.Trace``. The
solve's bits do not depend on any of it. ``SLAMSystem.timings`` keeps the
keys ``chip_smoke.py`` reads, now accumulated by the spans.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import manifest
from portbench import run as bench_run
from portbench import spans as pspans
from portbench.record import Run, Solve
from portbench.tests.helpers import BIG_SEED, CELLS, small_traffic
from portbench.trace import SOLVE, WINDOW, Trace
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.eval import timing
from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence, default_camera
from svi_mapper_tpu_torch.models.slam import SLAMSystem
from svi_mapper_tpu_torch.solvers import ba
from tests import torch_parity as tp

K, L, ITERS = 8, 256, 4
STAGES = ["svi.ba.assemble", "svi.ba.priors", "svi.ba.linear_solve", "svi.ba.update",
          "svi.ba.chi2", "svi.ba.flag_read"]
LAUNCH_READERS = ("chi2_launches_per_iter.ba", "priors_launches_per_iter.ba",
                  "update_launches_per_iter.ba")
ISSUE = "lm_issue_ms_per_iter.ba"
FIELDS = ("T_wc", "points_w", "chi2_initial", "chi2_final", "iterations")
# the keys of SLAMSystem.timings chip_smoke.py reads
TIMING_KEYS = {"frame_total", "kf_db_add", "kf_closure", "kf_backend", "kf_total", "kf_ba",
               "kf_pose_graph"}


@pytest.fixture(scope="module")
def problem():
    """A small BA window on the materialised route, with the pose chain and
    the gravity unaries on."""
    w = tp.ba_window(K=K, L=L, seed=3, noise=0.5, pose_noise=0.01)
    T = w["T_true"]
    odo = np.concatenate([T[1:] @ np.linalg.inv(T[:-1]), np.eye(4)[None]]).astype(np.float32)
    down = np.tile(np.float32([0.0, 1.0, 0.0]), (K, 1))
    args = (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]), tp.tbool(w["mask"]),
            default_camera(640, 480, device="cpu"), tp.tbool(w["fix"]))
    kw = dict(max_iterations=ITERS, min_rel_improvement=0.0, use_schur_kernel=False,
              device="cpu", odo_M=torch.from_numpy(odo), odo_w=torch.ones(K),
              grav_d=torch.from_numpy(down), grav_w=torch.full((K,), 10.0))
    return args, kw


def _solve(problem):
    args, kw = problem
    return ba.bundle_adjust(*args, **kw)


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record function was entered with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _children(timer, parent: int) -> list[int]:
    return [i for i, r in enumerate(timer.spans) if r.parent == parent]


def test_off_spans_are_the_shared_null_context_and_keep_nothing(problem, monkeypatch):
    _no_record_function(monkeypatch)
    assert timing.span("svi.ba.solve") is timing.span("svi.ba.chi2", 7) is timing._NULL
    idle = timing.StageTimer()
    res = _solve(problem)
    assert int(res.iterations) == ITERS
    assert idle.spans == [] and not idle.totals and not idle.counts
    # an accumulator times the body whether or not tracing is on
    acc = {}
    with timing.span("svi.frame.step", into=(acc, "frame_total")):
        pass
    with timing.span("svi.frame.step", into=(acc, "frame_total")):
        pass
    assert set(acc) == {"frame_total"} and acc["frame_total"] >= 0.0


def test_recording_keeps_each_stage_of_the_lm_loop(problem):
    timer = timing.StageTimer()
    with timer.recording():
        results = [_solve(problem), _solve(problem)]
    assert timing.span("svi.ba.solve") is timing._NULL        # uninstalled at the end
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in timer.spans)
    solves = [i for i, r in enumerate(timer.spans) if r.name == "svi.ba.solve"]
    assert len(solves) == 2 and all(timer.spans[i].parent is None for i in solves)
    requests = {timer.spans[i].request for i in solves}
    assert len(requests) == 2 and None not in requests
    for i, res in zip(solves, results):
        rid = timer.spans[i].request
        top = _children(timer, i)
        names = [timer.spans[j].name for j in top]
        assert names == ["svi.ba.chi2"] + ["svi.ba.iteration"] * int(res.iterations)
        for j in top[1:]:
            assert [timer.spans[c].name for c in _children(timer, j)] == STAGES
        tree = [j for j, r in enumerate(timer.spans) if _root(timer, j) == i]
        assert {timer.spans[j].request for j in tree} == {rid}
    assert timer.counts["svi.ba.iteration"] == sum(int(r.iterations) for r in results)
    assert timer.counts["svi.ba.chi2"] == timer.counts["svi.ba.iteration"] + 2
    own = timer.self_totals()
    assert set(own) == set(timer.totals)
    for name, seconds in own.items():
        assert 0.0 <= seconds <= timer.totals[name] + 1e-9
    assert "svi.ba.iteration" in timer.report(n_frames=1, wall_seconds=1.0)


def _root(timer, i: int) -> int:
    while timer.spans[i].parent is not None:
        i = timer.spans[i].parent
    return i


def test_two_threads_keep_separate_parent_stacks(problem):
    timer = timing.StageTimer()
    barrier = threading.Barrier(2)
    errors = []

    def work():
        try:
            barrier.wait()
            _solve(problem)
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    with timer.recording():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    solves = [i for i, r in enumerate(timer.spans) if r.name == "svi.ba.solve"]
    assert len(solves) == 2
    for r in timer.spans:
        if r.parent is not None:
            assert timer.spans[r.parent].request == r.request
            parent = timer.spans[r.parent]
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    for i in solves:
        assert len([j for j in _children(timer, i)
                    if timer.spans[j].name == "svi.ba.iteration"]) == ITERS


def test_recording_loses_no_span_under_thread_switches():
    """More threads than cores, switching every microsecond, each nesting
    spans under its own request: every span is kept, counted once and
    parented on its own thread."""
    n_threads, n_spans = 8, 300
    timer = timing.StageTimer()

    def work(rid):
        for _ in range(n_spans):
            with timing.span("svi.test.outer", rid):
                with timing.span("svi.test.inner", rid):
                    pass

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.recording():
            threads = [threading.Thread(target=work, args=(r,)) for r in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert timer.counts == {"svi.test.outer": n_threads * n_spans,
                            "svi.test.inner": n_threads * n_spans}
    assert len(timer.spans) == 2 * n_threads * n_spans
    for r in timer.spans:
        if r.name == "svi.test.inner":
            assert timer.spans[r.parent].name == "svi.test.outer"
            assert timer.spans[r.parent].request == r.request
        else:
            assert r.parent is None


def test_outputs_are_the_same_bits_off_recording_and_profiled(problem):
    off = _solve(problem)
    with timing.StageTimer().recording():
        recorded = _solve(problem)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _solve(problem)
    for res in (recorded, profiled):
        for f in FIELDS:
            assert torch.equal(getattr(off, f), getattr(res, f)), f


def _profiled_window(problem, n: int):
    run = Run(config={}, traffic={}, seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for i in range(n):
                with record_function(SOLVE):
                    res = _solve(problem)
                run.solves.append(Solve(segment=0, latency_s=0.0,
                                        iterations=int(res.iterations)))
    run.trace = Trace(prof)
    return run


def test_portbench_reads_the_spans_of_a_cpu_trace(problem):
    run = _profiled_window(problem, 2)
    spans = pspans.of(run)
    assert spans is not None and spans.iterations == run.iterations == 2 * ITERS
    assert spans.count["svi.ba.solve"] == 2 and spans.count["svi.ba.chi2"] == 2 * ITERS + 2
    for name in STAGES[:4] + ["svi.ba.flag_read"]:
        assert spans.count[name] == 2 * ITERS
    parents = {sp.name: spans.spans[sp.parent].name for sp in spans.spans if sp.parent >= 0
               and sp.name != "svi.ba.chi2"}
    assert parents == {**{n: "svi.ba.iteration" for n in STAGES if n != "svi.ba.chi2"},
                       "svi.ba.iteration": "svi.ba.solve"}
    issue = manifest.reader(ISSUE)(run)
    iteration_ms = 1e-6 * spans.host_ns["svi.ba.iteration"] / spans.iterations
    assert 0.0 < issue < iteration_ms
    for name in LAUNCH_READERS:
        assert manifest.reader(name)(run) is None       # no device operation on the CPU
    # with every span dropped (a program without them), every reader is silent
    rows = {r["span"]: r for r in spans.table(run.iterations)}
    assert rows["svi.ba.iteration"]["host_self_ms"] >= 0.0
    bare = _profiled_window_without_spans(problem)
    assert pspans.of(bare) is None
    for name in (ISSUE,) + LAUNCH_READERS:
        assert manifest.reader(name)(bare) is None


def _profiled_window_without_spans(problem):
    saved = ba.span
    ba.span = lambda *a, **k: timing._NULL
    try:
        return _profiled_window(problem, 1)
    finally:
        ba.span = saved


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_carries_the_span_metrics_when_traced(traced):
    cell = CELLS[0]
    result, _ = bench_run.run_cell(cell, BIG_SEED, 0.3, traced, torch.device("cpu"),
                                   traffic=small_traffic(cell))
    got = set(result["metrics"])
    if traced:
        assert ISSUE in got and result["metrics"][ISSUE]["value"] > 0.0
        assert result["metrics"][ISSUE]["unit"] == "ms/iter"
    else:
        assert ISSUE not in got
    assert not got & set(LAUNCH_READERS)


def test_slam_timings_keep_their_keys_through_the_spans():
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=256, max_detections=256, max_measurements=8,
        keyframe_translation_m2=0.4, keyframe_min_landmarks=10, optimize_every_keyframes=2)
    seq = SyntheticSequence(n_frames=12, width=320, height=192, step=0.35, device="cpu")
    frames = [seq.frame(i) for i in range(seq.n_frames)]
    left = torch.stack([f[0] for f in frames])
    right = torch.stack([f[1] for f in frames])
    slam = SLAMSystem(seq.cam, params, enable_local_ba=True, device="cpu")
    with np.errstate(over="ignore"):
        slam.process_many(left, right, chunk=6)
    assert slam.stats["ba_runs"] >= 1 and len(slam.slam_keyframes) >= 3
    assert set(slam.timings) == TIMING_KEYS - {"kf_pose_graph"}
    assert all(v > 0.0 for v in slam.timings.values())
    before = dict(slam.timings)
    timer = timing.StageTimer()
    with timer.recording():
        slam._optimize_pose_graph()
    assert set(slam.timings) == TIMING_KEYS
    assert slam.timings["kf_pose_graph"] == timer.totals["svi.slam.pose_graph"]
    assert {k: slam.timings[k] for k in before} == before
    assert timer.counts["svi.slam.pose_graph"] == 1
