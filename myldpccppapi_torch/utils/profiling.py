"""Tracing, phase timing, and metric emission.

Counterpart of ``myldpccppapi_tpu/utils/profiling.py``: named wall-clock
phase timers, an iterations-to-convergence histogram and one-line JSON
metrics (NumPy copies of the reference's), and :func:`trace`, which
records a ``torch.profiler`` trace (host and, on a CUDA device, kernel
activity) around a block and writes it into a directory as a Chrome
trace, where the reference captures a ``jax.profiler`` trace.

The program's own tracing lives only while a torch profiler records
(:func:`recording`), inside :func:`trace` or any ``torch.profiler.profile``
block: :func:`span` ranges named ``myldpc.*`` at its layer boundaries,
on the profiler's clock beside the device's activity, the stream kernel's
phase clocks (``ops/cuda_stream.py``) and the short-code kernel's slot
clocks (``ops/cuda_bp.py``).  Otherwise each costs a flag read.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["PhaseTimer", "trace", "iterations_histogram", "emit_metrics", "recording",
           "span"]

_NULL = contextlib.nullcontext()
#: the range a span records: a host-side range of the profiler's trace
#: (a ``record_function`` would also mark the device's activity inside it)
_Range = torch._C._profiler._RecordFunctionFast


def recording() -> bool:
    """True while a torch profiler records: the switch of the program's
    spans, of the stream kernel's phase clocks and of the short-code
    kernel's slot clocks."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager that records a range named ``"myldpc." + name``
    while a torch profiler records; otherwise one shared null context, with
    no profiler call and no allocation.

    >>> with span("decode"): ..."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Range("myldpc." + name)


class PhaseTimer:
    """Accumulating named wall-clock phase timers.

    >>> t = PhaseTimer()
    >>> with t.phase("h2d"): ...
    >>> with t.phase("decode"): ...
    >>> t.report()   # {'h2d': {'total_s': ..., 'calls': ...}, ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "calls": self.calls[k],
                "mean_s": self.totals[k] / max(self.calls[k], 1),
            }
            for k in sorted(self.totals)
        }

    def reset(self) -> None:
        self.totals.clear()
        self.calls.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (CPU activity, the
    program's ``myldpc.*`` spans, and CUDA kernels where CUDA is available)
    and export it into ``log_dir`` as ``trace_<pid>_<ns>.json`` (Chrome
    trace format, viewable in Perfetto or chrome://tracing); a no-op when
    ``log_dir`` is falsy.  When the stream kernel (``csrc/bp_stream.cu``)
    ran min-sum decodes in the block, its phase cycles of the block go
    beside it as one :func:`emit_metrics` line, ``stream_phases_<pid>_<ns>.json``:
    ``cycles`` (each slot of ``ops.cuda_stream.PHASE_SLOTS`` but the
    sweeps and turns, summed over the blocks), ``sweeps`` (frame-sweeps),
    ``turns`` (the blocks' turns) and ``per_frame_sweep`` (each of those
    cycles over the sweeps)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from ..ops import cuda_stream

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = cuda_stream.phase_cycles() or {}
    with profile(activities=activities) as prof:
        yield
    stem = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
    after = cuda_stream.phase_cycles() or {}
    moved = {k: v - before.get(k, 0) for k, v in after.items()}
    sweeps = moved.pop("sweeps", 0)
    turns = moved.pop("turns", 0)
    if sweeps:
        emit_metrics(os.path.join(log_dir, f"stream_phases_{stem}.json"),
                     cycles=moved, sweeps=sweeps, turns=turns,
                     per_frame_sweep={k: v / sweeps for k, v in moved.items()})


def iterations_histogram(iterations, max_iters: int) -> Dict[str, object]:
    """Iterations-to-convergence distribution as a first-class metric."""
    it = np.asarray(iterations).reshape(-1)
    counts = np.bincount(it, minlength=max_iters + 1)
    return {
        "mean": float(it.mean()) if it.size else float("nan"),
        "p50": float(np.percentile(it, 50)) if it.size else float("nan"),
        "p99": float(np.percentile(it, 99)) if it.size else float("nan"),
        "max": int(it.max()) if it.size else 0,
        "at_cap": int(counts[max_iters]) if max_iters < len(counts) else 0,
        "counts": counts.tolist(),
    }


def emit_metrics(path: Optional[str], **metrics) -> str:
    """Serialize metrics to one JSON object (written to ``path`` if given)."""
    s = json.dumps(metrics, sort_keys=True, default=float)
    if path:
        with open(path, "w") as f:
            f.write(s + "\n")
    return s
