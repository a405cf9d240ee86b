"""schur_roofline_pct.ba: the Schur assembly's share of its roofline, in %.

The least time the card could take for the assemblies the window needed
(one per LM iteration, each on its segment's mask, by the frozen
``portbench/work/schur.py``: operations at 67 TFLOP/s or bytes at
3.35 TB/s, whichever is longer) over the device time of the kernels K5
launches (``schur_assembly_kernel``, ``schur_product_kernel``,
``schur_reduce_kernel``: every kernel whose name holds ``schur_``), from the
profiler's trace. Silent where no such kernel ran."""

from portbench.work.schur import bound_seconds


def read(run):
    if run.trace is None or "schur" not in run.work:
        return None
    device = run.trace.device_seconds("schur_")
    if device <= 0:
        return None
    bounds = [bound_seconds(w) for w in run.work["schur"]]
    need = sum(s.iterations * bounds[s.segment] for s in run.solves)
    return 100.0 * need / device
