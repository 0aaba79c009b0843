"""The traced window: torch.profiler's events, the device's busy time,
and the breakdown of the result line.

Times are microseconds on the profiler's clock, which puts the card's
operations and the host's on one timeline.  The profiler runs from just
before the window opens to just after it closes, so the traced window
is the span of its events."""

from dataclasses import dataclass, field

import torch

TOP = 10


@dataclass
class Op:
    name: str
    start: float
    end: float
    device: int = 0


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)  # on the card, by start
    host_ops: list = field(default_factory=list)    # host ops and calls

    @property
    def window(self):
        """(start, end) of the traced window."""
        ops = self.device_ops + self.host_ops
        return min(o.start for o in ops), max(o.end for o in ops)

    def busy(self, device=0):
        """Merged intervals in which an operation ran on ``device``."""
        spans = []
        for op in self.device_ops:
            if op.device != device:
                continue
            if spans and op.start <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], op.end)
            else:
                spans.append([op.start, op.end])
        return spans

    def busy_seconds(self, device=0):
        """Seconds in which an operation ran on ``device``."""
        return sum(e - s for s, e in self.busy(device)) / 1e6

    def seconds_by_name(self, device=0):
        """Device seconds of each operation name on ``device``."""
        out = {}
        for op in self.device_ops:
            if op.device == device:
                out[op.name] = out.get(op.name, 0.0) + (op.end - op.start) / 1e6
        return out


def collect(prof):
    """A Trace of a finished torch.profiler.profile: every operation on
    a card (kernels, copies, memsets; not the ranges of annotations) and
    every host event."""
    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        op = Op(ev.name(), start, start + ev.duration_ns() / 1e3,
                ev.device_index())
        if ev.device_type() != cuda:
            tr.host_ops.append(op)
        elif not ev.is_user_annotation():
            tr.device_ops.append(op)
    for ops in (tr.device_ops, tr.host_ops):
        ops.sort(key=lambda o: (o.start, -o.end))
    return tr


def _top(totals):
    return [[name[:120], sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def breakdown(tr, device=0):
    """The result line's breakdown: the device operations that took most
    time, and the idle gaps summed by the innermost host event open at
    each gap's middle (seconds)."""
    lo, hi = tr.window
    gaps, prev = [], lo
    for s, e in tr.busy(device):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    idle = {}
    host = tr.host_ops
    stack, i = [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while i < len(host) and host[i].start <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        inner = next((op for op in reversed(stack) if op.end >= mid), None)
        name = inner.name if inner is not None else "host code outside torch"
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    return {"device_ops": _top(tr.seconds_by_name(device)),
            "idle_gaps": _top(idle)}
