"""obs_schur_roofline_pct.map: the observation-list route's Schur assembly
against its roofline, in %.

The least time the card could take for the assemblies the window needed
(one per LM iteration, each on its map's mask, by the frozen
``portbench/work/obs_schur.py``: operations at 67 TFLOP/s or bytes at
3.35 TB/s, whichever is longer) over the device time of every kernel
launched inside ``svi.ba.assemble`` (its ``svi.ba.pair_product`` child
included), whatever implements it, from the profiler's trace. Silent
where the program has no ``svi.ba.pair_product`` span (no such route)."""

from portbench.subtree import device_seconds_under
from portbench.work.obs_schur import bound_seconds


def read(run):
    if "obs_schur" not in run.work or device_seconds_under(run, "svi.ba.pair_product") is None:
        return None
    device = device_seconds_under(run, "svi.ba.assemble")
    if not device:
        return None
    bounds = [bound_seconds(w) for w in run.work["obs_schur"]]
    need = sum(s.iterations * bounds[s.segment] for s in run.solves)
    return 100.0 * need / device
