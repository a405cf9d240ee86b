"""Device time under a program span, children included: what the readers
of the observation-list route's metrics take from a traced run.

Each device operation belongs to the innermost program span that launched
it (``portbench.spans``); here it also counts for every span that holds
that one. Silent (``None``) where the run has no trace, no program spans, no
device operation (a run on the CPU), or no span of the name asked for:
the program then has no such stage."""

from __future__ import annotations

import weakref

from portbench import spans as program_spans

_owners: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def device_seconds_under(run, name: str, kinds=("kernel",)) -> float | None:
    """Device seconds of the operations of ``kinds`` launched inside a span
    ``name``, over the traced window; ``None`` where no span ``name`` is."""
    s = program_spans.of(run)
    if s is None or not s.trace.device or not s.count.get(name):
        return None
    under: dict[int, bool] = {-1: False}

    def inside(i: int) -> bool:
        chain = []
        while i not in under:
            if s.spans[i].name == name:
                under[i] = True
                break
            chain.append(i)
            i = s.spans[i].parent
        for j in chain:
            under[j] = under[i]
        return under[i]

    if s.trace not in _owners:
        _owners[s.trace] = [s.owner(d.op) for d in s.trace.device]
    total = 0
    for d, i in zip(s.trace.device, _owners[s.trace]):
        if d.kind in kinds and inside(i):
            total += d.end - d.start
    return total * 1e-9
