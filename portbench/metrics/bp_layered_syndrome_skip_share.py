"""The share of kernel A's block-sweeps (``csrc/bp_layered.cu``) whose exact
syndrome pass the block skipped, in %: the program's slot counter
(``ops/cuda_bp.py``) holds the clocked kernel's syndrome skips (sweeps in
which an odd row of the last layer, read from its write-back, ruled out
every codeword of the block that was not done, times the tile) and its
block-sweeps (sweeps run times the tile), each summed over every layered
min-sum launch made while the profiler recorded (in a traced receive run:
the slice, the two calls before it and the call that starts the profiler
in set-up).  Skips over block-sweeps.  None where the program's counter
has no such slot or counted no sweep."""


def read(ctx):
    from myldpccppapi_torch.ops import cuda_bp

    slot_clocks = getattr(cuda_bp, "slot_clocks", None)
    got = slot_clocks() if slot_clocks is not None else None
    if not got or "syndrome_skips" not in got or not got.get("block_sweeps"):
        return None
    return 100.0 * got["syndrome_skips"] / got["block_sweeps"]
