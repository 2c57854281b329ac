"""The yardstick of the kernels' roofline shares: the card's published peaks,
and the operations and bytes a decode needs, counted here from the code's
size and the plain reference's iterations, never from the program's.

A decode's least time is the larger of its operations over the card's
rate of one non-fused f32 operation per lane and clock, and its bytes
(each LLR read once, each output written once) over the HBM rate.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["OPS_PER_EDGE_SWEEP", "PEAKS", "decode_bytes", "decode_ops",
           "least_seconds", "peaks_of"]

#: NVIDIA's H100 SXM data sheet: 67 TFLOP/s FP32 outside the tensor
#: cores counts a fused multiply-add as two, so one non-fused f32
#: operation per lane and clock is half of it; HBM3 at 3.35 TB/s.  The
#: rates assume the full 700 W power limit.
PEAKS = {"H100": {"f32_ops_per_s": 67e12 / 2, "bytes_per_s": 3.35e12}}

#: f32 operations per edge and sweep that a layered min-sum decode needs,
#: each one instruction: q (1), the two least magnitudes and the sign (2
#: mins, a max, a compare: 4), the compare of |q| with the least, the
#: magnitude and sign selects (3), the delta and its add to the posterior
#: (2).  An abs or a negation is an operand modifier, not counted.
OPS_PER_EDGE_SWEEP = 10


def peaks_of(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def decode_ops(edges: int, sweeps: int) -> float:
    """Operations of ``sweeps`` codeword-sweeps (summed over frames) of a
    layered min-sum decode of a code of ``edges`` Tanner-graph edges."""
    return float(edges) * sweeps * OPS_PER_EDGE_SWEEP


def decode_bytes(n: int, batch: int) -> float:
    """Bytes of one decode of ``batch`` frames: the f32 LLRs read, and the
    bits (1 B each), converged flags (1 B) and iteration counts (4 B)
    written."""
    return float(batch) * (n * 4 + n * 1 + 1 + 4)


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["f32_ops_per_s"], nbytes / peaks["bytes_per_s"])
