"""File loggers — the CLogger static-logger family.

The reference's ``CLogger`` (CLogger.h:51-302) ships seven printf-to-file
loggers under ``logs/``: landmark creation, trajectory, final landmarks
(plain + optimized), epipolar detection, odometry optimization iterations,
IMU input, and the KITTI-format trajectory. :class:`RunLogger` recreates
them as plain-text files with the same roles and the JAX package's line
formats; attach one to a tracker via :func:`attach` and everything is
written incrementally from the per-frame outputs the host already holds.

On a tracker whose state ``parallel.mesh.shard_state`` placed on a ``map``
mesh, every rank attaches and finalizes: the per-frame outputs are the same
on every rank and rank 0 writes them, and :func:`finalize` gathers the
table on every rank (a collective) and returns once rank 0's dumps are
written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A host copy; a replicated DTensor's local one (reads no other rank)."""
    if not torch.is_tensor(a):
        return np.asarray(a)
    from svi_mapper_tpu_torch.convert import host_arrays

    return host_arrays(a)[0]


class _Discard:
    """The file of a logger that does not write (a rank other than 0)."""

    def write(self, text: str) -> None:
        pass

    def close(self) -> None:
        pass


class RunLogger:
    """Per-run text logs under ``log_dir`` (ref CLogger targets logs/*.txt).
    With ``write=False`` it opens no file and drops every line (the ranks
    other than 0 of a sharded run)."""

    def __init__(self, log_dir: str | Path, write: bool = True):
        self.dir = Path(log_dir)
        self.write = write
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._files: dict[str, object] = {}

    def _f(self, name: str):
        if name not in self._files:
            self._files[name] = (open(self.dir / f"{name}.txt", "w") if self.write
                                 else _Discard())
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
        table to the host, every row of a sharded table: then every rank
        must call it (a gather)."""
        from svi_mapper_tpu_torch.convert import host_arrays

        self._final_landmarks(*host_arrays(table.active, table.uid, table.pos_w,
                                           table.is_optimal))

    def _final_landmarks(self, active, uid, pos, opt) -> None:
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
    the live state, once per frame that created landmarks. On a sharded
    tracker only rank 0's logger writes."""
    from svi_mapper_tpu_torch.models.frame import shards_of

    shards = shards_of(tracker.state)
    logger = RunLogger(log_dir, write=shards is None or shards.rank == 0)
    orig = tracker.process
    orig_many = getattr(tracker, "process_many", None)

    def _log_one(idx: int, out) -> None:
        logger.frame(idx, out)
        logger.trajectory_pose(idx, out.T_wc)
        if int(out.n_new):
            logger.landmarks_created(idx, int(out.n_new),
                                     int(_np(tracker.state.next_uid)))
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
    """Write the end-of-run dumps and close the files. On a sharded tracker
    every rank must call it: the table is gathered, rank 0 writes, and the
    ranks return together once the files are closed."""
    from svi_mapper_tpu_torch import convert

    t = tracker.state.table
    rows = convert.host_arrays(t.active, t.uid, t.pos_w, t.is_optimal)

    def write() -> None:
        logger._final_landmarks(*rows)
        if tracker.trajectory:
            logger.kitti_trajectory(np.stack([_np(T) for T in tracker.trajectory]))
        logger.close()

    convert.write_on_rank0(tracker.state, write)
    logger.close()
