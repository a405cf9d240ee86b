"""ba_solve_p95_ms: the 95th percentile (linear between order statistics)
of every solve of the window, each timed on the host clock from its call
to its result on the host."""

import numpy as np


def read(run):
    if not run.solves:
        return None
    return float(np.percentile([s.latency_s for s in run.solves], 95)) * 1e3
