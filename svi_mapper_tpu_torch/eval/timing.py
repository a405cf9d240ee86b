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

:func:`span` marks a stage of the program (``svi.ba.*`` in the LM loop,
``svi.frame.*`` and ``svi.slam.*`` in the trackers and the back-end). It
costs two flag checks and hands back one shared null context unless a
profiler runs or a timer records:

* under a running ``torch.profiler`` the span is a host event on the
  profiler's timeline, on the clock of the device's kernels, and the
  innermost operator of whatever it launches outside an aten operator;
* under :meth:`StageTimer.recording` the timer keeps the span in memory
  (name, start and end on ``time.perf_counter_ns``, parent, request) and
  adds it to its buckets.

A span given ``into=(dict, key)`` adds its host duration to ``dict[key]``
whether or not tracing is on (``SLAMSystem.timings``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

DATASET_FPS = 20.0   # the reference's real-time definition (tracker_gt.cpp:275)

_NULL = contextlib.nullcontext()
_recording: StageTimer | None = None      # the timer StageTimer.recording installed
_requests = itertools.count(1)


def next_request() -> int:
    """A request id for the spans of one call, unique in the process."""
    return next(_requests)


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span a recording :class:`StageTimer` kept. ``parent`` is the
    index in ``StageTimer.spans`` of the span that held it on its thread
    (``None`` at the top)."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    request: int | None


class _Span:
    """The context :func:`span` hands back while tracing is on or an
    accumulator is given."""

    __slots__ = ("name", "request", "into", "timer", "profiled", "_rf", "_t0", "_index")

    def __init__(self, name, request, into, timer, profiled):
        self.name, self.request, self.into = name, request, into
        self.timer, self.profiled = timer, profiled

    def __enter__(self):
        if self.profiled:
            # a function-scoped record function: a host event with no copy
            # on the device's timeline, unlike record_function's user scope
            rf_cls = torch._C._profiler._RecordFunctionFast
            self._rf = (rf_cls(self.name) if self.request is None
                        else rf_cls(self.name, [], {"request": self.request}))
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        if self.timer is not None:
            self._index = self.timer._open(self.name, self._t0, self.request)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.timer is not None:
            self.timer._close(self._index, t1)
        if self.into is not None:
            d, key = self.into
            d[key] = d.get(key, 0.0) + (t1 - self._t0) * 1e-9
        if self.profiled:
            self._rf.__exit__(None, None, None)
        return False


def span(name: str, request: int | None = None, into: tuple[dict, str] | None = None):
    """A context marking the stage ``name`` (see the module's docstring).
    ``request`` ties the spans of one call together; ``into=(d, key)`` adds
    the host duration to ``d[key]``."""
    timer = _recording
    profiled = _autograd_profiler._is_profiler_enabled
    if timer is None and not profiled and into is None:
        return _NULL
    return _Span(name, request, into, timer, profiled)


class StageTimer:
    """Accumulating wall-clock buckets (the CTimer + bucket pattern)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.spans: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def recording(self):
        """Install this timer for the process: every :func:`span` on any
        thread is kept in ``spans`` and added to the buckets until the
        body ends."""
        global _recording
        previous, _recording = _recording, self
        try:
            yield self
        finally:
            _recording = previous

    def _open(self, name: str, start_ns: int, request: int | None) -> int:
        stack = self._local.__dict__.setdefault("stack", [])
        with self._lock:
            index = len(self.spans)
            self.spans.append(SpanRecord(name, start_ns, None,
                                         stack[-1] if stack else None, request))
        stack.append(index)
        return index

    def _close(self, index: int, end_ns: int) -> None:
        self._local.stack.pop()
        rec = self.spans[index]
        rec.end_ns = end_ns
        with self._lock:
            self.totals[rec.name] += (end_ns - rec.start_ns) * 1e-9
            self.counts[rec.name] += 1

    def self_totals(self) -> dict[str, float]:
        """Seconds of each span name less the time its child spans cover."""
        child = defaultdict(int)
        for r in self.spans:
            if r.parent is not None and r.end_ns is not None:
                child[r.parent] += r.end_ns - r.start_ns
        out: dict[str, float] = defaultdict(float)
        for i, r in enumerate(self.spans):
            if r.end_ns is not None:
                out[r.name] += (r.end_ns - r.start_ns - child[i]) * 1e-9
        return dict(out)

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
