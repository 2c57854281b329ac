"""Sweeps per turn of D's port (``csrc/bp_stream.cu``): the program's phase
counter (``ops/cuda_stream.py``) holds the frame-sweeps and the turns that
the clocked kernel's persistent blocks ran, each summed over every decode
made while the profiler recorded (in a traced receive run: the slice, the
two calls before it and the call that starts the profiler in set-up).  A
batch past the card's resident blocks runs each codeword in turns of a few
sweeps; a batch that fits runs one turn a codeword, where this reads the
mean sweeps.  None where the program's counter has no turns (a kernel that
decodes one codeword a block to its end) or counted none."""


def read(ctx):
    from myldpccppapi_torch.ops import cuda_stream

    phase_cycles = getattr(cuda_stream, "phase_cycles", None)
    got = phase_cycles() if phase_cycles is not None else None
    if not got or not got.get("turns"):
        return None
    return got["sweeps"] / got["turns"]
