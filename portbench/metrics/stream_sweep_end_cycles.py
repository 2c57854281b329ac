"""Cycles per frame-sweep of D's port (``csrc/bp_stream.cu``) in a sweep's end
(the hard decisions, the exact syndrome and the latch), as thread 0 of each
block of the clocked kernel counts them: the program's phase counter
(``ops/cuda_stream.py``), its cycles and its sweeps both summed over every
decode made while the profiler recorded (in a traced receive run: the slice,
the two calls before it and the call that starts the profiler in set-up)."""
from portbench.program_trace import stream_phase_cycles


def read(ctx):
    return stream_phase_cycles("sweep_end")
