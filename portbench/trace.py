"""What a traced run reads from ``torch.profiler``'s timeline.

The profiler wraps the measured window; the benchmark marks the window and
each solve with ``record_function`` spans (``WINDOW`` and ``SOLVE``). From
the raw events (``kineto_results.events()``, without building PyTorch's
per-event objects, which a window of a million launches makes slow) this
keeps, inside the window:

* the device's operations: kernels, copies and fills, with their span, kind
  and correlation id;
* the host's operators (``aten::*`` and the like), by correlation id, which
  each device operation carries as its linked id: so each device operation
  is traced back to the innermost host operator that launched it.

Busy time is the union of the device operations' spans; an idle gap is a
stretch of the window that no device operation covers, named after the host
operator that launched the device operation ending it (``dispatch/<op>``):
what the host was doing while the card waited.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "portbench.window"
SOLVE = "portbench.solve"
NAME_CHARS = 80


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int       # ns
    end: int
    kind: str        # "kernel", "gpu_memcpy" or "gpu_memset"
    op: int          # correlation id of the host operator that launched it


def _short(name: str) -> str:
    return name[:NAME_CHARS]


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Trace:
    """The window's events, read once from a stopped profiler.

    An event on the CUDA device is a device operation, except the device's
    copies of the benchmark's own spans; on the host, the rest of the
    events but the benchmark's spans and the launches (CUDA runtime and
    driver calls) are operators, each with its correlation id, which the
    device operations it launched carry as their linked id."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        results = prof.profiler.kineto_results
        spans, dev, ops = [], [], {}
        for e in results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append(DeviceOp(name, e.start_ns(), e.end_ns(), _device_kind(name),
                                    e.linked_correlation_id()))
            elif name in (WINDOW, SOLVE):
                spans.append((name, e.start_ns(), e.end_ns()))
            elif e.linked_correlation_id() == 0 and not name.startswith(("cuda", "cu")):
                ops[e.correlation_id()] = (e.start_ns(), e.end_ns(), name,
                                           e.start_thread_id())
        windows = [(s, t) for n, s, t in spans if n == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' spans, not one")
        self.start, self.end = windows[0]
        self.device = sorted((d for d in dev if d.name not in (WINDOW, SOLVE)
                              and d.start < self.end and d.end > self.start),
                             key=lambda d: d.start)
        self._ops = ops

    # -- the window and the device's busy time -------------------------------
    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def _busy_and_gaps(self):
        busy, gaps = 0, []
        cursor = self.start
        for d in self.device:
            s, t = max(d.start, self.start), min(d.end, self.end)
            if s > cursor:
                gaps.append((cursor, s, d))
            if t > cursor:
                busy += t - max(s, cursor)
                cursor = t
        if cursor < self.end:
            gaps.append((cursor, self.end, None))
        return busy, gaps

    @property
    def busy_s(self) -> float:
        return self._busy_and_gaps()[0] * 1e-9

    # -- counts and device time by name --------------------------------------
    def count(self, kind: str, name_part: str = "") -> int:
        return sum(1 for d in self.device if d.kind == kind and name_part in d.name)

    def device_seconds(self, name_part: str, kind: str = "kernel") -> float:
        return sum(d.end - d.start for d in self.device
                   if d.kind == kind and name_part in d.name) * 1e-9

    def launched_under(self, op_names: tuple[str, ...]) -> float:
        """Device seconds of the operations launched by a host operator
        named in ``op_names`` or by one it called (an operator that starts
        inside such an operator's span on its thread)."""
        spans: dict[int, list] = {}
        for s, t, n, th in self._ops.values():
            if n in op_names:
                spans.setdefault(th, []).append((s, t))
        for v in spans.values():
            v.sort()
        starts = {th: [s for s, _ in v] for th, v in spans.items()}
        total = 0
        for d in self.device:
            op = self._ops.get(d.op)
            if op is None or op[3] not in spans:
                continue
            v = spans[op[3]]
            i = bisect.bisect_right(starts[op[3]], op[0]) - 1
            if i >= 0 and v[i][1] >= op[0]:
                total += d.end - d.start
        return total * 1e-9

    # -- the breakdown the result line carries -------------------------------
    def top_device_ops(self, n: int = 10) -> list[list]:
        by = {}
        for d in self.device:
            key = _short(d.name)
            by[key] = by.get(key, 0) + (d.end - d.start)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def top_idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds summed by what ended them: ``dispatch/<host op>``
        for the innermost host operator that launched the next device
        operation (``dispatch/-`` where none is known), ``window_end`` for
        the stretch after the last one."""
        _, gaps = self._busy_and_gaps()
        by = {}
        for s, t, d in gaps:
            if d is None:
                key = "window_end"
            else:
                op = self._ops.get(d.op)
                key = f"dispatch/{_short(op[2]) if op else '-'}"
            by[key] = by.get(key, 0) + (t - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]
