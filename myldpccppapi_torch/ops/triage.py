"""Two-phase (triage) decoding: fast pass + compacted straggler re-decode.

Counterpart of ``myldpccppapi_tpu/ops/triage.py``.  One unconverged codeword
holds its whole tile (a TPU lane tile, a CUDA thread block) at the
iteration cap.  The triage wrapper runs a short first pass, compacts the
unconverged frames into a buffer of ``cap`` frames, and re-decodes only
those at the full budget.  Codewords are independent and BP is
deterministic, so the result is bit-identical to a single pass.  If more
than ``cap`` frames fail the fast pass, the whole batch is re-decoded.
Where the reference chooses between the two branches with ``lax.cond``,
this eager port reads the failure count to the host once.
"""
from __future__ import annotations

from typing import Callable

import torch

from .bp import DecodeResult

__all__ = ["decode_two_phase", "merge_rows"]


def decode_two_phase(
    decode_fast: Callable[[torch.Tensor], DecodeResult],
    decode_full: Callable[[torch.Tensor], DecodeResult],
    llr: torch.Tensor,
    cap: int,
) -> DecodeResult:
    """Triage-decode [B, n] LLRs.

    ``decode_fast``: short-budget decoder (the first pass).
    ``decode_full``: full-budget decoder, for the [cap, n] straggler batch
    or, when more than ``cap`` frames fail, the whole batch.  Frames are
    compacted on ``~ok``: with CRC-aided acceptance a rejected frame gets
    the full budget, and ``accepted`` is merged with the rest.
    """
    res1 = decode_fast(llr)
    bad = ~res1.ok  # [B]: not accepted (syndrome, and CRC when CRC-aided)
    if int(bad.sum()) > cap:
        return decode_full(llr)
    # stable partition: indices of unaccepted frames first, accepted
    # frames after them as filler
    order = torch.argsort((~bad).to(torch.uint8), stable=True)
    sel = order[:cap]
    res2 = decode_full(llr[sel])
    return merge_rows(res1, res2, sel, bad[sel])


def merge_rows(res1: DecodeResult, res2: DecodeResult, sel: torch.Tensor,
               take: torch.Tensor) -> DecodeResult:
    """``res1`` with its rows ``sel`` replaced by ``res2``'s rows where
    ``take`` (the others of ``sel`` are filler and keep ``res1``'s values):
    bits, converged, iterations, ``accepted`` and the posteriors where
    ``res1`` has them; ``total_iters`` the larger of the two."""

    def merge(a, b):
        if a is None:
            return None
        out = a.clone()
        mask = take.view(-1, *([1] * (a.dim() - 1)))
        out[sel] = torch.where(mask, b.to(a.dtype), a[sel])
        return out

    return DecodeResult(
        bits=merge(res1.bits, res2.bits),
        converged=merge(res1.converged, res2.converged),
        iterations=merge(res1.iterations, res2.iterations),
        total_iters=torch.maximum(res1.total_iters, res2.total_iters),
        accepted=merge(res1.accepted, res2.accepted),
        posteriors=merge(res1.posteriors, res2.posteriors),
    )
