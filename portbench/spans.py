"""The program's own spans on a traced run's timeline, and what the device
did inside each.

The port marks the stages of its LM loop with host spans named ``svi.*``
(``svi_mapper_tpu_torch.eval.timing.span``: ``svi.ba.solve``,
``svi.ba.iteration``, ``svi.ba.assemble``, ``svi.ba.priors``,
``svi.ba.linear_solve``, ``svi.ba.update``, ``svi.ba.chi2``,
``svi.ba.flag_read``). Under the profiler each is a host event among the
operators ``portbench.trace.Trace`` keeps, on the clock of the device's
operations. Here, inside the window:

* each device operation belongs to the innermost program span that holds
  the host operator that launched it, by that operator's start and thread
  (an operator that is itself a span, as for the kernels launched through
  ctypes, belongs to that span); an operation with no such span belongs to
  ``OUTSIDE``;
* each span's host time, with and without its child spans, and the
  device's idle time inside it, with and without its child spans.

A program without these spans gives no ``svi.ba.iteration`` span, and the
readers that use this module are silent there.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> [--out FILE]

runs one traced window of a cell on the card and prints each span name's
figures per LM iteration, then one untraced window under a recording
``StageTimer`` with the same figures from the host clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import weakref

PREFIX = "svi."
ITERATION = "svi.ba.iteration"
FLAG_READ = "svi.ba.flag_read"
OUTSIDE = "(outside every span)"

_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class Span:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    thread: int
    parent: int         # index into ProgramSpans.spans, -1 at the top


class ProgramSpans:
    """The window's program spans and the device's operations assigned to
    them, read once from a ``portbench.trace.Trace``."""

    def __init__(self, trace):
        self.trace = trace
        found = []
        for corr, (s, t, name, thread) in trace._ops.items():
            if name.startswith(PREFIX) and s >= trace.start and t <= trace.end:
                found.append((thread, s, -t, name, corr))
        order = sorted(range(len(found)), key=lambda i: found[i][:3])
        self.spans: list[Span] = []
        index_of = {}
        stacks: dict[int, list[int]] = {}
        for i in order:
            thread, s, neg_t, name, corr = found[i]
            stack = stacks.setdefault(thread, [])
            while stack and self.spans[stack[-1]].end <= s:
                stack.pop()
            index_of[corr] = len(self.spans)
            self.spans.append(Span(name, s, -neg_t, thread, stack[-1] if stack else -1))
            stack.append(len(self.spans) - 1)
        self._span_of_op = index_of
        self._by_thread: dict[int, list[int]] = {}
        for i, sp in enumerate(self.spans):
            self._by_thread.setdefault(sp.thread, []).append(i)
        self._starts = {th: [self.spans[i].start for i in v]
                        for th, v in self._by_thread.items()}
        self._assign()
        self._times()

    # -- which span a device operation belongs to ----------------------------
    def owner(self, op_corr: int) -> int:
        """The innermost program span holding host operator ``op_corr``, or
        -1."""
        if op_corr in self._span_of_op:
            return self._span_of_op[op_corr]
        op = self.trace._ops.get(op_corr)
        if op is None or op[3] not in self._by_thread:
            return -1
        start, thread = op[0], op[3]
        j = bisect.bisect_right(self._starts[thread], start) - 1
        if j < 0:
            return -1
        i = self._by_thread[thread][j]
        while i >= 0 and self.spans[i].end < start:
            i = self.spans[i].parent
        return i

    def _assign(self) -> None:
        self.launches: dict[str, int] = {}
        self.device_ns: dict[str, int] = {}
        for d in self.trace.device:
            i = self.owner(d.op)
            name = self.spans[i].name if i >= 0 else OUTSIDE
            if d.kind == "kernel":
                self.launches[name] = self.launches.get(name, 0) + 1
            self.device_ns[name] = self.device_ns.get(name, 0) + (d.end - d.start)

    # -- host and idle time by span ------------------------------------------
    def _times(self) -> None:
        _, gaps = self.trace._busy_and_gaps()
        g_start = [s for s, _, _ in gaps]
        g_end = [t for _, t, _ in gaps]
        cum = [0]
        for s, t in zip(g_start, g_end):
            cum.append(cum[-1] + (t - s))

        def idle(a: int, b: int) -> int:
            i = bisect.bisect_right(g_end, a)         # first gap ending after a
            j = bisect.bisect_left(g_start, b)        # gaps starting before b
            if i >= j:
                return 0
            total = cum[j] - cum[i]
            total -= max(0, a - g_start[i])
            total -= max(0, g_end[j - 1] - b)
            return total

        n = len(self.spans)
        host = [sp.end - sp.start for sp in self.spans]
        idle_in = [idle(sp.start, sp.end) for sp in self.spans]
        child_host, child_idle = [0] * n, [0] * n
        for i, sp in enumerate(self.spans):
            if sp.parent >= 0:
                child_host[sp.parent] += host[i]
                child_idle[sp.parent] += idle_in[i]
        self.count: dict[str, int] = {}
        self.host_ns: dict[str, int] = {}
        self.host_self_ns: dict[str, int] = {}
        self.idle_ns: dict[str, int] = {}
        self.idle_self_ns: dict[str, int] = {}
        self.issue_ns = 0
        for i, sp in enumerate(self.spans):
            for d, v in ((self.count, 1), (self.host_ns, host[i]),
                         (self.host_self_ns, host[i] - child_host[i]),
                         (self.idle_ns, idle_in[i]),
                         (self.idle_self_ns, idle_in[i] - child_idle[i])):
                d[sp.name] = d.get(sp.name, 0) + v
            if sp.name == ITERATION:
                self.issue_ns += host[i]
            elif sp.name == FLAG_READ and sp.parent >= 0 \
                    and self.spans[sp.parent].name == ITERATION:
                self.issue_ns -= host[i]
        top_host = sum(host[i] for i, sp in enumerate(self.spans) if sp.parent < 0)
        top_idle = sum(idle_in[i] for i, sp in enumerate(self.spans) if sp.parent < 0)
        self.host_self_ns[OUTSIDE] = (self.trace.end - self.trace.start) - top_host
        self.idle_self_ns[OUTSIDE] = idle(self.trace.start, self.trace.end) - top_idle

    @property
    def iterations(self) -> int:
        return self.count.get(ITERATION, 0)

    def table(self, iterations: int) -> list[dict]:
        """One row per span name (and ``OUTSIDE``), per LM iteration:
        kernels, device ms, host ms (all and self), idle ms (all and
        self)."""
        names = sorted(set(self.count) | set(self.launches) | {OUTSIDE})
        per = 1.0 / max(iterations, 1)
        return [dict(span=n, count=self.count.get(n, 0),
                     kernels=self.launches.get(n, 0) * per,
                     device_ms=self.device_ns.get(n, 0) * 1e-6 * per,
                     host_ms=self.host_ns.get(n, 0) * 1e-6 * per,
                     host_self_ms=self.host_self_ns.get(n, 0) * 1e-6 * per,
                     idle_ms=self.idle_ns.get(n, 0) * 1e-6 * per,
                     idle_self_ms=self.idle_self_ns.get(n, 0) * 1e-6 * per)
                for n in names]


def of(run) -> ProgramSpans | None:
    """The program spans of a traced run, or ``None`` where the run has no
    trace or its trace holds no ``svi.ba.iteration`` span."""
    trace = run.trace
    if trace is None:
        return None
    if trace not in _cache:
        _cache[trace] = ProgramSpans(trace)
    spans = _cache[trace]
    return spans if spans.iterations > 0 else None


def launches_per_iteration(run, name: str) -> float | None:
    """Kernels whose innermost program span is ``name``, over the run's LM
    iterations; ``None`` without program spans or device operations."""
    spans = of(run)
    if spans is None or not spans.trace.device or run.iterations == 0:
        return None
    return spans.launches.get(name, 0) / run.iterations


# -- the per-stage study on the card ------------------------------------------

def _window(name: str, seed: int, seconds: float, traced: bool, device):
    """One window of the cell as ``portbench.run`` drives it: returns the
    run record, with its trace when ``traced``, and the recording timer
    when not."""
    import time

    import torch

    from portbench import manifest
    from portbench.record import Run, Solve
    from portbench.trace import SOLVE, WINDOW, Trace
    from svi_mapper_tpu_torch.eval.timing import StageTimer

    c = manifest.cell(manifest.load(), name)
    run = Run(config=c["config"], traffic=c["traffic"], seed=seed)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    drv = manifest.driver(run.traffic)(run, device)
    drv.warm_up()
    torch.cuda.synchronize(device)
    timer = StageTimer()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        mark = torch.profiler.record_function
        ctx = mark(WINDOW)
    else:
        mark = None
        ctx = timer.recording()
    start = time.perf_counter()
    with ctx:
        i = 0
        while True:
            t0 = time.perf_counter()
            if mark is not None:
                with mark(SOLVE):
                    seg, iters = drv.solve(i)
            else:
                seg, iters = drv.solve(i)
            t1 = time.perf_counter()
            run.solves.append(Solve(segment=seg, latency_s=t1 - t0, iterations=iters))
            i += 1
            if t1 - start >= seconds:
                break
    run.window_s = t1 - start
    torch.cuda.synchronize(device)
    if traced:
        prof.stop()
        run.trace = Trace(prof)
    return run, timer


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    ap = argparse.ArgumentParser(prog="portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lines = []
    run, _ = _window(args.workload, args.seed, args.seconds, True, dev)
    spans = ProgramSpans(run.trace)
    for row in spans.table(run.iterations):
        lines.append(dict(cell=args.workload, seed=args.seed, clock="profiler", **row))
    lines.append(dict(cell=args.workload, seed=args.seed, clock="profiler", span="(window)",
                      iterations=run.iterations, solves=len(run.solves),
                      window_s=run.trace.window_s, busy_s=run.trace.busy_s,
                      kernels=run.trace.count("kernel") / max(run.iterations, 1),
                      issue_ms=spans.issue_ns * 1e-6 / max(spans.iterations, 1)))
    del run, spans
    run, timer = _window(args.workload, args.seed, args.seconds, False, dev)
    per = 1e3 / max(run.iterations, 1)
    own = timer.self_totals()
    for name in sorted(timer.totals):
        lines.append(dict(cell=args.workload, seed=args.seed, clock="host", span=name,
                          count=timer.counts[name], host_ms=timer.totals[name] * per,
                          host_self_ms=own.get(name, 0.0) * per))
    issue = timer.totals.get(ITERATION, 0.0) - timer.totals.get(FLAG_READ, 0.0)
    lines.append(dict(cell=args.workload, seed=args.seed, clock="host", span="(window)",
                      iterations=run.iterations, solves=len(run.solves),
                      window_s=run.window_s, lm_iters_per_s=run.iterations / run.window_s,
                      issue_ms=issue * per,
                      flag_read_ms=timer.totals.get(FLAG_READ, 0.0) * per))
    for row in lines:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
