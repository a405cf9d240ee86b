"""File loggers — the CLogger static-logger family.

The reference's ``CLogger`` (CLogger.h:51-302) ships seven printf-to-file
loggers under ``logs/``: landmark creation, trajectory, final landmarks
(plain + optimized), epipolar detection, odometry optimization iterations,
IMU input, and the KITTI-format trajectory. :class:`RunLogger` recreates
them as plain-text files with the same roles and the JAX package's line
formats; attach one to a tracker via :func:`attach` and everything is
written incrementally from the per-frame outputs the host already holds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class RunLogger:
    """Per-run text logs under ``log_dir`` (ref CLogger targets logs/*.txt)."""

    def __init__(self, log_dir: str | Path):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._files: dict[str, object] = {}

    def _f(self, name: str):
        if name not in self._files:
            self._files[name] = open(self.dir / f"{name}.txt", "w")
        return self._files[name]

    # --- per-frame loggers -------------------------------------------------
    def frame(self, idx: int, out) -> None:
        """Odometry/optimization log (role of CLogOptimizationOdometry):
        per-frame solver outcome + tracking counters."""
        f = self._f("odometry_optimization")
        f.write(
            f"{idx} posit_ok={int(out.posit_ok)} inliers={int(out.inliers)} "
            f"err_px2={float(out.avg_error_px2):.4f} "
            f"tracked={int(out.n_tracked)} active={int(out.n_active)} "
            f"optimal={int(out.n_optimal)} new={int(out.n_new)} "
            f"keyframe={int(out.is_keyframe)}\n")

    def trajectory_pose(self, idx: int, T_wc) -> None:
        """Per-frame camera center (role of CLogTrajectory)."""
        T = _np(T_wc)
        c = -T[:3, :3].T @ T[:3, 3]
        self._f("trajectory").write(
            f"{idx} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")

    def imu(self, idx: int, omega, accel, dt: float) -> None:
        """IMU input log (role of CLogIMUInput)."""
        o = _np(omega)
        a = _np(accel)
        self._f("imu_input").write(
            f"{idx} dt={dt:.6f} w=({o[0]:.6f},{o[1]:.6f},{o[2]:.6f}) "
            f"a=({a[0]:.6f},{a[1]:.6f},{a[2]:.6f})\n")

    def landmarks_created(self, idx: int, n_new: int, total_uid: int) -> None:
        """Landmark creation log (role of CLogLandmarkCreation)."""
        self._f("landmark_creation").write(
            f"{idx} new={n_new} next_uid={total_uid}\n")

    def epipolar(self, idx: int, n_tracked: int, n_failed: int) -> None:
        """Epipolar detection log (role of CLogDetectionEpipolar)."""
        self._f("epipolar_detection").write(
            f"{idx} tracked={n_tracked} failed={n_failed}\n")

    # --- end-of-run loggers ------------------------------------------------
    def final_landmarks(self, table) -> None:
        """Final landmark dumps (roles of CLogLandmarkFinal and
        CLogLandmarkFinalOptimized: all vs accepted-optimal). Reads the
        table to the host."""
        active = _np(table.active)
        uid = _np(table.uid)
        pos = _np(table.pos_w)
        opt = _np(table.is_optimal)
        f_all = self._f("landmarks_final")
        f_opt = self._f("landmarks_final_optimized")
        for i in np.flatnonzero(active):
            line = (f"{uid[i]} {pos[i, 0]:.6f} {pos[i, 1]:.6f} "
                    f"{pos[i, 2]:.6f}\n")
            f_all.write(line)
            if opt[i]:
                f_opt.write(line)

    def kitti_trajectory(self, T_wc_stack) -> None:
        """KITTI-format trajectory (role of CLogTrajectoryKITTI,
        CLogger.h:264-302)."""
        from svi_mapper_tpu_torch.eval.trajectory import save_kitti_trajectory

        save_kitti_trajectory(self.dir / "trajectory_kitti.txt", _np(T_wc_stack))

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def attach(tracker, log_dir: str | Path) -> RunLogger:
    """Wrap a tracker's ``process`` (and ``process_many``) so every frame is
    logged; returns the logger (call ``finalize(tracker, logger)`` or use it
    as a context). ``next_uid`` of the landmark-creation log is read from
    the live state, once per frame that created landmarks."""
    logger = RunLogger(log_dir)
    orig = tracker.process
    orig_many = getattr(tracker, "process_many", None)

    def _log_one(idx: int, out) -> None:
        logger.frame(idx, out)
        logger.trajectory_pose(idx, out.T_wc)
        if int(out.n_new):
            logger.landmarks_created(idx, int(out.n_new),
                                     int(tracker.state.next_uid))
        logger.epipolar(idx, int(out.n_tracked),
                        int(out.n_active) - int(out.n_tracked))

    def process(*args, **kwargs):
        out = orig(*args, **kwargs)
        _log_one(tracker.frame_count - 1, out)
        return out

    def process_many(*args, **kwargs):
        outs = orig_many(*args, **kwargs)
        base = tracker.frame_count - len(outs)
        for i, out in enumerate(outs):
            _log_one(base + i, out)
        return outs

    tracker.process = process
    if orig_many is not None:
        tracker.process_many = process_many
    return logger


def finalize(tracker, logger: RunLogger) -> None:
    """Write the end-of-run dumps and close the files."""
    logger.final_landmarks(tracker.state.table)
    if tracker.trajectory:
        logger.kitti_trajectory(np.stack([_np(T) for T in tracker.trajectory]))
    logger.close()
