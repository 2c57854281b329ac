"""The program's own tracing, read for per-layer metrics: its spans and the
stream kernel's phase counter.

* Spans (``myldpccppapi_torch/utils/profiling.py``): host ranges named
  ``myldpc.*`` in the profiler's trace, on the clock of the device's
  activity, recorded only while the profiler records.  ``myldpc.decode``
  is a ``Decoder`` call; ``myldpc.long.prepare``, ``.launch`` and
  ``.finish`` are its consecutive children in the long-code wrapper.  The
  functions below take them as a name -> intervals dict
  (:func:`program_spans` makes it from the profiler's raw events).
* The phase counter (``ops/cuda_stream.py``): cycles that thread 0 of each
  block of ``csrc/bp_stream.cu``'s clocked kernel spent in each phase of
  its layers and sweeps, with the blocks' resident cycles and sweeps,
  summed over every min-sum decode made while a profiler recorded in this
  process.

An operator gets both outside the benchmark with
``myldpccppapi_torch.utils.profiling.trace(dir)``: the Chrome trace, and
beside it ``stream_phases_<pid>_<ns>.json``.  In a ``--trace 1`` run the
metrics ``stream_stage_cycles``, ``stream_pass1_cycles``,
``stream_pass2_cycles`` and ``stream_sweep_end_cycles`` read the phase
counter (:func:`stream_phase_cycles`): in a receive run that is the slice,
the two calls before it and the call that starts the profiler in set-up.
No metric reads the spans yet, since ``trace.Trace`` keeps only the
benchmark's own spans.  The card test of the clocked kernel against the
unclocked one at the gateway's size is ``tests/test_portbench_phases.py``
(``python3 -m pytest portbench/tests -m card -q -s``).
"""
from __future__ import annotations

import collections
from typing import Dict, List

from portbench.trace import Interval, covered, merge

__all__ = ["PREFIX", "idle_unspanned_ms", "mean_ms", "program_spans", "self_ms",
           "stream_phase_cycles"]

#: the prefix of the program's span names
PREFIX = "myldpc."


def program_spans(events) -> Dict[str, List[Interval]]:
    """The host ranges named ``myldpc.*`` among the profiler's raw events:
    name without the prefix -> sorted intervals in ns."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans: Dict[str, List[Interval]] = collections.defaultdict(list)
    for e in events:
        name = e.name()
        if name.startswith(PREFIX) and e.device_type() != cuda:
            start = e.start_ns()
            spans[name[len(PREFIX):]].append((start, start + e.duration_ns()))
    for v in spans.values():
        v.sort()
    return dict(spans)


def _inside(ivs: List[Interval], lo: int, hi: int) -> List[Interval]:
    return [(a, b) for a, b in ivs if a >= lo and b <= hi]


def mean_ms(spans: Dict[str, List[Interval]], name: str, lo: int, hi: int, calls: int):
    """The summed length of the spans ``name`` that lie inside [lo, hi], per
    call, in ms; None without such a span or calls."""
    got = _inside(spans.get(name, []), lo, hi)
    if not got or calls <= 0:
        return None
    return sum(b - a for a, b in got) / calls / 1e6


def self_ms(spans: Dict[str, List[Interval]], name: str, lo: int, hi: int, calls: int):
    """The self time of the spans ``name`` inside [lo, hi] (each span's
    length less the part that the other program spans inside it cover), per
    call, in ms; None without such a span or calls."""
    got = _inside(spans.get(name, []), lo, hi)
    if not got or calls <= 0:
        return None
    total = 0
    for a, b in got:
        children = merge([iv for other, ivs in spans.items() for iv in ivs
                          if iv != (a, b) and a <= iv[0] and iv[1] <= b])
        total += (b - a) - covered(children, a, b)
    return total / calls / 1e6


def _gaps(merged: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi] that the disjoint, sorted ``merged`` leaves."""
    out, at = [], lo
    for a, b in merged:
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def idle_unspanned_ms(trace, spans: Dict[str, List[Interval]]):
    """The mean, over the benchmark's ``portbench.call`` spans, of the time
    inside a call that neither the device's activity nor any program span
    covers, in ms: the part of ``host_gap_ms`` that the program does not
    name.  None without calls or program spans."""
    calls = trace.spans.get("call", [])
    if not calls or not spans:
        return None
    named = merge([iv for ivs in spans.values() for iv in ivs])
    idle = [g for lo, hi in calls for g in _gaps(trace.busy, lo, hi)]
    return sum((b - a) - covered(named, a, b) for a, b in idle) / len(calls) / 1e6


def stream_phase_cycles(slot: str):
    """The program's phase counter's ``slot`` (a phase, or ``resident``) per
    frame-sweep, over every clocked decode of this process; None where the
    program has no phase counter or it counted no sweep."""
    from myldpccppapi_torch.ops import cuda_stream

    read = getattr(cuda_stream, "phase_cycles", None)
    got = read() if read is not None else None
    if not got or not got.get("sweeps"):
        return None
    return got[slot] / got["sweeps"]
