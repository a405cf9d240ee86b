"""lm_iters_per_s: all LM iterations the program reported for the solves of
the window, over all the time of the window (host clock, from the first
call to the last result on the host)."""


def read(run):
    if not run.solves or run.window_s <= 0:
        return None
    return run.iterations / run.window_s
