"""The traced slice: ``torch.profiler``'s raw events, read without its event
tree (which takes seconds at a hundred thousand kernels), and the
benchmark's own spans.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``
that the drivers open around their calls into the program: they land in
the trace on the same clock as the device's activity.  ``portbench.slice``
bounds the traced slice.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

__all__ = ["SPAN", "Trace", "covered", "merge"]

#: the prefix of the benchmark's own spans
SPAN = "portbench."

Interval = Tuple[int, int]


def merge(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint union of ``intervals``."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(merged: List[Interval], lo: int, hi: int) -> int:
    """Length of ``[lo, hi]`` that the disjoint ``merged`` covers."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


class Trace:
    """Device activity (kernels, copies, sets) and the benchmark's spans of
    one traced slice, in ns on the profiler's clock."""

    def __init__(self, events):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[str, int, int]] = []
        self.spans: Dict[str, List[Interval]] = collections.defaultdict(list)
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if name.startswith(SPAN):
                if e.device_type() != cuda:
                    self.spans[name[len(SPAN):]].append((start, end))
                continue  # the device-side copy of a span is no activity
            if e.device_type() == cuda:
                self.device.append((name, start, end))
        for v in self.spans.values():
            v.sort()
        self.busy = merge([(a, b) for _, a, b in self.device])
        lo, hi = self.spans["slice"][0] if self.spans.get("slice") else (0, 0)
        self.lo, self.hi = lo, hi

    @property
    def window_ns(self) -> int:
        return self.hi - self.lo

    @property
    def busy_ns(self) -> int:
        return covered(self.busy, self.lo, self.hi)

    def kernel_ns(self, needle: str) -> int:
        """Summed device time, inside the slice, of operations whose name
        holds ``needle``."""
        return sum(min(b, self.hi) - max(a, self.lo) for name, a, b in self.device
                   if needle in name and b > self.lo and a < self.hi)

    def idle_gaps(self) -> List[Interval]:
        gaps, at = [], self.lo
        for a, b in self.busy:
            if b <= self.lo or a >= self.hi:
                continue
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.hi:
            gaps.append((at, self.hi))
        return gaps

    def span_at(self, t: int) -> str:
        """The innermost span (other than the slice) holding time ``t``."""
        best, width = "outside the spans", None
        for name, ivs in self.spans.items():
            if name == "slice":
                continue
            for a, b in ivs:
                if a <= t <= b and (width is None or b - a < width):
                    best, width = name, b - a
        return best

    def host_gap_ns(self, span: str) -> List[int]:
        """For each ``span``, its time that no device activity covers."""
        return [(b - a) - covered(self.busy, a, b) for a, b in self.spans.get(span, [])]

    def breakdown(self, top: int = 10) -> dict:
        """The slice's device operations that took most time, and its
        longest idle gaps by the span that held them, in seconds."""
        ops = collections.Counter()
        for name, a, b in self.device:
            if b > self.lo and a < self.hi:
                ops[name] += (min(b, self.hi) - max(a, self.lo)) / 1e9
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[self.span_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps]}
