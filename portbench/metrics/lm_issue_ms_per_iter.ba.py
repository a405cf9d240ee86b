"""lm_issue_ms_per_iter.ba: the host's time an LM iteration spends issuing
work, in ms: the host time of every ``svi.ba.iteration`` span of the window
less its ``svi.ba.flag_read`` child (the iteration's one wait on the
device), over the window's iteration spans. It is the host's dispatch of an
iteration under the profiler, which slows each launch; untraced figures
come from a recording ``StageTimer`` (``python3 -m portbench.spans``).
Silent where the program has no such span."""

from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return 1e-6 * s.issue_ns / s.iterations
