"""Per-stage timing instrumentation and end-of-run reports.

Replaces the reference's manual wall-clock accumulators and exit report
(``CTimer`` CTimer.h:14-29; per-stage buckets in CFundamentalMatcher.h:100-106
and CSolverStereoPosit.h:101; the printed time budget tracker_gt.cpp:285-308
with avg fps and "x real time" at the assumed 20 fps dataset rate).

:class:`StageTimer` keeps host-clock buckets: a bucket around device work
measures the device only if the work ends in a read or a
``torch.cuda.synchronize()`` inside it. :func:`trace` records a
``torch.profiler`` trace (host and, where a CUDA device exists, device
activity) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

DATASET_FPS = 20.0   # the reference's real-time definition (tracker_gt.cpp:275)


class StageTimer:
    """Accumulating wall-clock buckets (the CTimer + bucket pattern)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self, n_frames: int, wall_seconds: float) -> str:
        """The end-of-run time budget (format of tracker_gt.cpp:285-308)."""
        lines = [
            "-" * 64,
            f"frames: {n_frames}   wall: {wall_seconds:.2f} s   "
            f"avg fps: {n_frames / max(wall_seconds, 1e-9):.2f}   "
            f"x real time: {(n_frames / DATASET_FPS) / max(wall_seconds, 1e-9):.2f}",
            "-" * 64,
        ]
        total_tracked = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            share = t / max(wall_seconds, 1e-9) * 100.0
            lines.append(
                f"  {name:<28s} {t:8.3f} s  ({share:5.1f} %)  x{self.counts[name]}"
            )
        lines.append(f"  {'(untracked)':<28s} {max(wall_seconds - total_tracked, 0.0):8.3f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | Path = "svi_mapper_tpu_torch_trace"):
    """``torch.profiler`` trace of the body; ``<log_dir>/trace.json`` (a
    Chrome trace, open it in Perfetto or ``chrome://tracing``) is written
    when the body ends, also when it raises. Records the device's kernels
    where a CUDA device exists."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))
