"""pair_product_ms_per_iter.map: device time of the kernels launched
inside ``svi.ba.pair_product`` (the co-visible pairs' blocks of the reduced
camera system and their sums into it), per LM iteration, in ms. Silent
where the program has no such span."""

from portbench.subtree import device_seconds_under


def read(run):
    seconds = device_seconds_under(run, "svi.ba.pair_product")
    if seconds is None or run.iterations == 0:
        return None
    return 1e3 * seconds / run.iterations
