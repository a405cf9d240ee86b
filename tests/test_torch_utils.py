"""The port's host utilities against the JAX package's: fault injection
(``utils/faults.py``, mirroring the fault tests of ``tests/test_tools.py``:
one seed plants the same faults in both), the run loggers
(``utils/loggers.py``: the same files, line for line), the stage timer and
trace (``eval/timing.py``), the stage budget (``eval/stage_bench.py``, run
here on the CPU at a small size for its names and shape only; its times
come from the card) and the error classes (``utils/errors.py``)."""

import dataclasses
import inspect
import json

import numpy as np
import pytest

from svi_mapper_tpu.eval.timing import StageTimer as JStageTimer
from svi_mapper_tpu.utils import errors as jerrors
from svi_mapper_tpu.utils import faults as jfaults
from svi_mapper_tpu.utils import loggers as jloggers
from svi_mapper_tpu_torch.eval import stage_bench, timing
from svi_mapper_tpu_torch.utils import errors, faults, loggers

CPU = "cpu"
STAGES = ("dense_brief_x2", "tracking_window", "stereo_rematch", "posit_gn",
          "regional_recovery", "landmark_gn", "detect_corners", "ba_window_10lm",
          "ba_window_prep", "pose_graph_64kf", "closure_match_icp", "closure_query_fused")


def test_flip_descriptor_bits_exact_count_and_same_faults():
    d = np.random.default_rng(4).integers(0, 2 ** 32, size=(10, 8),
                                          dtype=np.uint64).astype(np.uint32)
    out = faults.flip_descriptor_bits(d, 6, np.random.default_rng(7))
    pop = np.unpackbits((d ^ out).view(np.uint8), axis=-1).sum(-1)
    assert (pop == 6).all()
    np.testing.assert_array_equal(out, jfaults.flip_descriptor_bits(d, 6, np.random.default_rng(7)))
    assert np.array_equal(faults.flip_descriptor_bits(d, 0, np.random.default_rng(7)), d)
    # int32 bit patterns (the port's descriptors) flip the same bits
    out32 = faults.flip_descriptor_bits(d.view(np.int32), 6, np.random.default_rng(7))
    assert out32.dtype == np.int32
    np.testing.assert_array_equal(out32.view(np.uint32), out)


def test_drop_measurements_fraction_and_same_faults():
    mask = np.ones(100, bool)
    mask[::7] = False
    out = faults.drop_measurements(mask, 0.3, np.random.default_rng(2))
    assert out.sum() == mask.sum() - int(0.3 * mask.sum())
    assert not (out & ~mask).any()
    np.testing.assert_array_equal(out, jfaults.drop_measurements(mask, 0.3,
                                                                 np.random.default_rng(2)))
    assert (~mask).sum() == 15                # input untouched


def test_perturb_pose_is_rigid_and_same_faults():
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    out = faults.perturb_pose(T, 0.1, 0.05, np.random.default_rng(3))
    R = out[:3, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1) < 1e-5
    assert not np.allclose(out, T)
    np.testing.assert_array_equal(out, jfaults.perturb_pose(T, 0.1, 0.05,
                                                            np.random.default_rng(3)))


@dataclasses.dataclass
class _Out:
    T_wc: np.ndarray
    posit_ok: bool
    inliers: int
    avg_error_px2: float
    n_tracked: int
    n_active: int
    n_optimal: int
    n_new: int
    is_keyframe: bool


@dataclasses.dataclass
class _Table:
    active: np.ndarray
    uid: np.ndarray
    pos_w: np.ndarray
    is_optimal: np.ndarray


@dataclasses.dataclass
class _State:
    table: _Table
    next_uid: int


class _Tracker:
    """A stand-in tracker: ``process`` returns prepared outputs."""

    def __init__(self, outs, state):
        self.outs, self.state, self.frame_count, self.trajectory = outs, state, 0, []

    def process(self, *_):
        out = self.outs[self.frame_count]
        self.frame_count += 1
        self.trajectory.append(out.T_wc)
        return out

    def process_many(self, n):
        return [self.process() for _ in range(n)]


def test_loggers_write_the_jax_files(tmp_path, rng):
    outs = []
    for i in range(5):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3)
        outs.append(_Out(T, i % 2 == 0, 10 + i, 0.5 * i, 40 + i, 50 + i, 30 + i,
                         3 * (i % 2), i == 2))
    table = _Table(active=np.array([True, False, True, True]),
                   uid=np.array([4, 5, 6, 7], np.int32),
                   pos_w=rng.normal(size=(4, 3)).astype(np.float32),
                   is_optimal=np.array([True, True, False, True]))
    dirs = {}
    for name, mod in (("port", loggers), ("jax", jloggers)):
        tr = _Tracker(outs, _State(table, 42))
        log = mod.attach(tr, tmp_path / name)
        tr.process()
        tr.process()
        tr.process_many(3)
        log.imu(4, np.array([0.1, 0.2, 0.3]), np.array([1.0, 2.0, 9.8]), 0.005)
        mod.finalize(tr, log)
        dirs[name] = tmp_path / name
    files = sorted(p.name for p in dirs["jax"].iterdir())
    assert files == sorted(p.name for p in dirs["port"].iterdir())
    assert {"odometry_optimization.txt", "trajectory.txt", "landmark_creation.txt",
            "epipolar_detection.txt", "imu_input.txt", "landmarks_final.txt",
            "landmarks_final_optimized.txt", "trajectory_kitti.txt"} <= set(files)
    for f in files:
        a, b = (dirs["port"] / f).read_text(), (dirs["jax"] / f).read_text()
        if f == "trajectory_kitti.txt":
            np.testing.assert_allclose(np.loadtxt(dirs["port"] / f), np.loadtxt(dirs["jax"] / f),
                                       rtol=0, atol=1e-6)
        else:
            assert a == b, f


def test_stage_timer_report_as_jax():
    reports = []
    for cls in (timing.StageTimer, JStageTimer):
        timer = cls()
        timer.add("track", 0.25)
        timer.add("ba", 0.5)
        timer.add("ba", 0.25)
        reports.append(timer.report(n_frames=100, wall_seconds=2.0))
    assert reports[0] == reports[1]
    assert "avg fps: 50.00" in reports[0] and "x real time: 2.50" in reports[0]
    timer = timing.StageTimer()
    with timer.stage("track"):
        pass
    assert timer.counts["track"] == 1 and timer.totals["track"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with timing.trace(tmp_path / "tr") as d:
        torch.ones(64).sum()
    data = json.loads((d / "trace.json").read_text())
    assert data["traceEvents"]
    with pytest.raises(ZeroDivisionError):
        with timing.trace(tmp_path / "tr2"):
            1 / 0
    assert (tmp_path / "tr2" / "trace.json").exists()


def test_stage_budget_names_on_the_cpu():
    budget = stage_bench.stage_budget(width=160, height=96, reps=1, device=CPU)
    assert tuple(budget) == STAGES
    assert all(np.isfinite(v) and v > 0 for v in budget.values())
    text = stage_bench.format_budget(budget)
    assert all(name in text for name in STAGES) and "front-end stage sum" in text


def test_error_classes_as_jax():
    names = [n for n, c in inspect.getmembers(jerrors, inspect.isclass)
             if c.__module__ == jerrors.__name__]
    assert len(names) == 10
    for n in names:
        mine = getattr(errors, n)
        assert [b.__name__ for b in mine.__mro__] == \
            [b.__name__ for b in getattr(jerrors, n).__mro__], n
    assert issubclass(errors.InvalidFileError, ValueError)
    assert issubclass(errors.EndOfFileError, EOFError)
