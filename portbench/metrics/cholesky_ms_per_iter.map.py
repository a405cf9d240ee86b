"""cholesky_ms_per_iter.map: device time of the whole map's reduced camera
system's factor and solve (4,470 x 4,470 at 745 keyframes), per LM
iteration, in ms: every device operation launched inside
``aten::linalg_cholesky_ex`` or ``aten::cholesky_solve`` (the library's
kernels included), from the profiler's trace."""

OPS = ("aten::linalg_cholesky_ex", "aten::cholesky_solve")


def read(run):
    if run.trace is None or run.iterations == 0:
        return None
    seconds = run.trace.launched_under(OPS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.iterations
