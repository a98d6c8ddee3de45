"""The traced window: device operations and the benchmark's host spans
from ``torch.profiler`` (CUPTI), reduced to what the per-layer readers
and the result's ``device`` and ``breakdown`` need.

The profiling is a frozen copy of the port's ``utils/profiling.py``
``device_window``: a window in which the profiler recorded no device event
is profiled again once, and a second such window raises rather than report
another clock under a device metric's name. The reduction is new: the busy
time is the union of the device operations' intervals, and the idle gaps
between them are named by the host span that covers each gap's middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

SPAN_PREFIX = "perfbench."
STEP_SPAN = "perfbench.step"


class LostDeviceEvents(RuntimeError):
    """torch.profiler recorded no device event in a window of device work."""


@dataclass
class DeviceTrace:
    """One profiled window of ``steps`` whole steps. Times in microseconds
    on the profiler's clock; ``ops`` and ``spans`` are (name, start, end)."""

    ops: list
    spans: list
    start: float
    end: float
    steps: int
    wall_s: float = 0.0
    by_op: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in busy_intervals(self.ops, self.start, self.end)) / 1e6

    def op_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(min(e, self.end) - max(s, self.start)
                   for n, s, e in self.ops if match(n) and e > self.start and s < self.end) / 1e6


def busy_intervals(ops, start: float, end: float) -> list:
    """The union of the operations' intervals, clipped to [start, end]."""
    out: list = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(trace: DeviceTrace) -> list:
    """[(label, seconds)] of every gap in the device's busy time inside the
    window, labelled by the innermost benchmark span (other than the step's
    own) covering the gap's middle; "perfbench.step" where only the step
    covers it, "host" where no span does."""
    busy = busy_intervals(trace.ops, trace.start, trace.end)
    edges = [trace.start] + [x for iv in busy for x in iv] + [trace.end]
    # The benchmark's spans follow one another; the step's spans hold them.
    inner = sorted((s for s in trace.spans if s[0] != STEP_SPAN), key=lambda s: s[1])
    steps = sorted((s for s in trace.spans if s[0] == STEP_SPAN), key=lambda s: s[1])

    def covering(spans, starts, t):
        k = bisect.bisect_right(starts, t) - 1
        return spans[k][0] if k >= 0 and spans[k][2] >= t else None

    inner_starts, step_starts = [s[1] for s in inner], [s[1] for s in steps]
    gaps = []
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi > lo:
            mid = (lo + hi) / 2
            label = (covering(inner, inner_starts, mid) or covering(steps, step_starts, mid)
                     or "host")
            gaps.append((label, (hi - lo) / 1e6))
    return gaps


def summarise(pairs, top: int = 10) -> list:
    """[[name, seconds]] summed by name, the largest ``top``."""
    acc: dict = defaultdict(float)
    for name, sec in pairs:
        acc[name] += sec
    return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity and
    argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120] or name[:120]


def profile_steps(step: Callable[[int], None], steps: int) -> DeviceTrace:
    """Profile ``steps`` calls of ``step(i)`` (each a whole step that ends
    in a synchronize, inside a ``perfbench.step`` span)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                step(i)
            wall_s = time.perf_counter() - t0
        ops, spans = [], []
        for e in prof.events():
            rng = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.name.startswith(SPAN_PREFIX):
                # A span also shows on the device's timeline: it is no operation.
                if e.device_type != DeviceType.CUDA:
                    spans.append(rng)
            elif e.device_type == DeviceType.CUDA:
                ops.append(rng)
        step_spans = [s for s in spans if s[0] == STEP_SPAN]
        if ops and step_spans:
            start = min(s[1] for s in step_spans)
            end = max(s[2] for s in step_spans)
            tr = DeviceTrace(ops=ops, spans=spans, start=start, end=end,
                             steps=len(step_spans), wall_s=wall_s)
            tr.by_op = dict(summarise(((short_name(n), (e - s) / 1e6) for n, s, e in ops),
                                      top=10 ** 6))
            return tr
    raise LostDeviceEvents("torch.profiler recorded no device time, twice")
