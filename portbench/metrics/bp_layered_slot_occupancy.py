"""The share of the card's block slots that kernel A's port
(``csrc/bp_layered.cu``) kept busy, in %: the program's slot counter
(``ops/cuda_bp.py``), where thread 0 of each block of the clocked kernel
reads ``%globaltimer`` at its entry and exit, holds the blocks' resident ns
and each launch's slot-ns (its slots, SMs times the blocks of its tile that
one SM holds, times the span from its first entry to its last exit), each
summed over every layered min-sum launch made while the profiler recorded
(in a traced receive run: the slice, the two calls before it and the call
that starts the profiler in set-up).  Resident ns over slot-ns.  None where
the program has no slot counter or it counted no launch."""


def read(ctx):
    from myldpccppapi_torch.ops import cuda_bp

    slot_clocks = getattr(cuda_bp, "slot_clocks", None)
    got = slot_clocks() if slot_clocks is not None else None
    if not got or not got.get("launches") or not got.get("slot_ns"):
        return None
    return 100.0 * got["resident_ns"] / got["slot_ns"]
