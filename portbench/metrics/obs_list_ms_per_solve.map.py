"""obs_list_ms_per_solve.map: device time (kernels, copies and fills)
inside ``svi.ba.obs_list``, where a solve turns its ``[K, L]`` mask into
the lists of observations and co-visible pairs, per solve, in ms. Silent
where the program has no such span."""

from portbench.subtree import device_seconds_under


def read(run):
    seconds = device_seconds_under(run, "svi.ba.obs_list",
                                   ("kernel", "gpu_memcpy", "gpu_memset"))
    if seconds is None or not run.solves:
        return None
    return 1e3 * seconds / len(run.solves)
