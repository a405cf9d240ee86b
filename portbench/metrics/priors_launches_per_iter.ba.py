"""priors_launches_per_iter.ba: kernels whose innermost program span is
``svi.ba.priors`` (the pose chain's ``log_se3`` and adjoint, the gravity
unaries), over the LM iterations of the window's solves. Silent where the
program has no spans or the trace holds no device operation."""

from portbench import spans


def read(run):
    return spans.launches_per_iteration(run, "svi.ba.priors")
