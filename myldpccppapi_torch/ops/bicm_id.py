"""BICM-ID: iterative demapping <-> decoding.

Counterpart of ``myldpccppapi_tpu/ops/bicm_id.py``.  The one-shot receive
chain demaps once and decodes (``sim.py``).  With a non-Gray labeling the
demapper leaves mutual information behind that decoder feedback recovers:
BICM-ID feeds the decoder's extrinsic LLRs back as the demapper's a priori
and decodes again (Li & Ritcey 1997; ten Brink's EXIT analysis).  The
reference C++ library has no counterpart; it rests on the decoders' soft
output at kernel rate: the feedback passes run the long-code kernel's
soft-output mode on 5G NR and DVB-S2 (csrc/bp_long.cu) and the short-code
kernel's on 802.16e (csrc/bp_layered.cu).

* extrinsics are exchanged, not APPs: the demapper returns the APP and the
  loop subtracts the prior it fed; the decoder's extrinsic is its
  posterior minus its channel input;
* an optional interleaver pair maps between codeword bit order and mapper
  bit order (the EN 302 307 §5.3.3 column interleaver,
  ``codes.dvbs2.bit_interleave``; identity by default), which the feedback
  crosses in both directions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..utils.config import DecoderConfig
from ..utils.device import DEFAULT_DEVICE
from .modulation import Modulation, demap_llr

__all__ = ["bicm_id_receive", "make_bicm_id_receive"]


def make_bicm_id_receive(
    code,
    cfg: DecoderConfig,
    mod: Modulation,
    n_outer: int = 2,
    method: str = "maxlog",
    extrinsic_scale: float = 1.0,
    deinterleave: Optional[Callable] = None,
    interleave: Optional[Callable] = None,
    *,
    device=DEFAULT_DEVICE,
):
    """Build ``receive(y, n0) -> DecodeResult`` running ``n_outer``
    demapper <-> decoder extrinsic exchanges after the first pass, with two
    ``Decoder``s on ``device`` (the card unless ``"cpu"``): one with soft
    output for the feedback passes, the caller's ``cfg`` for the last.

    ``cfg`` must not preset ``soft_output`` (the loop manages it).
    ``extrinsic_scale``: damping on the decoder -> demapper feedback (1.0 =
    none).  ``deinterleave``/``interleave``: mapper-order -> codeword-order
    LLR permutation and its inverse (identity when None).
    """
    if cfg.soft_output:
        raise ValueError("leave soft_output unset; the loop manages it")
    if n_outer < 0:
        raise ValueError(f"n_outer must be >= 0, got {n_outer}")
    from ..decoder import Decoder

    dec_soft = Decoder(code, dataclasses.replace(cfg, soft_output=True), device=device)
    dec_last = Decoder(code, cfg, device=device)
    de_il = deinterleave if deinterleave is not None else (lambda x: x)
    il = interleave if interleave is not None else (lambda x: x)

    def receive(y, n0):
        app = demap_llr(y, n0, mod, method)          # first pass: no prior
        llr_in = de_il(app)                          # codeword order
        for _ in range(n_outer):
            res = dec_soft(llr_in)
            dec_ext = (res.posteriors - llr_in) * extrinsic_scale
            prior = il(dec_ext)                      # mapper order
            app = demap_llr(y, n0, mod, method, prior=prior)
            llr_in = de_il(app - prior)              # demapper extrinsic
        return dec_last(llr_in)

    return receive


def bicm_id_receive(code, cfg, y, n0, mod, n_outer=2, method="maxlog",
                    extrinsic_scale=1.0, deinterleave=None, interleave=None, *,
                    device=DEFAULT_DEVICE):
    """One-call form of :func:`make_bicm_id_receive` (builds the decoders
    on every call; prefer the factory in a loop)."""
    fn = make_bicm_id_receive(code, cfg, mod, n_outer, method, extrinsic_scale,
                              deinterleave, interleave, device=device)
    return fn(y, n0)
