"""What one run records: the cell, the set-up time, each solve of the
window and, in a traced run, the profiler's trace. The metric readers
under ``portbench/metrics/`` read nothing else."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Solve:
    segment: int          # index into the ring of inputs
    latency_s: float      # from the call to the result on the host
    iterations: int       # LM iterations the program reports


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    solves: list = dataclasses.field(default_factory=list)
    work: dict = dataclasses.field(default_factory=dict)   # per-segment yardstick
    trace: object = None                                   # portbench.trace.Trace

    @property
    def iterations(self) -> int:
        return sum(s.iterations for s in self.solves)
