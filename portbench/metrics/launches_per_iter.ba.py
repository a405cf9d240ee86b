"""launches_per_iter.ba: the kernels the card ran in the traced window
(every kernel, the libraries' included), over the LM iterations of the
solves the window holds."""


def read(run):
    if run.trace is None or run.iterations == 0:
        return None
    return run.trace.count("kernel") / run.iterations
