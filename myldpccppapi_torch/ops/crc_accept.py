"""CRC- and outer-code-aided acceptance around the syndrome-only kernels.

Counterpart of ``myldpccppapi_tpu/ops/crc_accept.py``.  The CUDA kernels
early-exit on the LDPC syndrome alone, which admits wrong-codeword
convergence.  Rather than a per-sweep CRC product inside the kernels, this
wrapper keeps them lean and hands the rare rejected frames to the plain
path:

1. run the kernel (syndrome early exit) over the whole batch;
2. one CRC / BCH check of the decoded information blocks on the device;
3. the frames whose syndrome converged but whose check failed are
   compacted and re-decoded at the full budget by the check-aware plain
   decode (its exact syndrome, never the lazy one), on the same device.

The plain version is bit-exact with the kernel (f32; under bf16 the retry
is the plain version with the kernel's own rounding points), so the
re-decode replays the kernel's iterations up to the wrong-codeword
convergence and then goes on past it: the composite equals a kernel with
the check in its latch.  Where the reference chooses its branch with
``lax.cond``, this eager port reads one count to the host.
"""
from __future__ import annotations

from typing import Callable

import torch

from .bp import DecodeResult
from .triage import merge_rows

__all__ = ["decode_with_crc_accept"]


def decode_with_crc_accept(
    inner: Callable[[torch.Tensor], DecodeResult],
    retry_full: Callable[[torch.Tensor], DecodeResult],
    crc_fail: Callable[[torch.Tensor], torch.Tensor],
    llr: torch.Tensor,
    cap: int,
) -> DecodeResult:
    """CRC-aided decode of [B, n] LLRs.

    ``inner``:      syndrome-only decoder for the full batch (a kernel,
                    possibly triage-wrapped); its ``accepted`` is None.
    ``retry_full``: check-aware decoder (the plain path with ``cfg.crc`` or
                    ``cfg.outer`` set) for any batch size: for the
                    compacted rejected frames, or the whole batch when more
                    than ``cap`` are rejected.
    ``crc_fail``:   [B, n] hard bits -> bool[B] (ops/bp.accept_fail_fn).
    ``cap``:        straggler-buffer capacity (frames).
    """
    res1 = inner(llr)
    ok1 = res1.converged & ~crc_fail(res1.bits)
    # only syndrome-converged frames that fail the check behave otherwise
    # under a check-aware decode; unconverged ones would replay the same
    # trajectory to the same cap
    bad = res1.converged & ~ok1
    n_bad = int(bad.sum())
    if n_bad == 0:
        return res1._replace(accepted=ok1)
    if cap >= llr.shape[0] or n_bad > cap:
        return retry_full(llr)
    order = torch.argsort((~bad).to(torch.uint8), stable=True)  # rejected first
    sel = order[:cap]
    res2 = retry_full(llr[sel])
    return merge_rows(res1._replace(accepted=ok1), res2, sel, bad[sel])
