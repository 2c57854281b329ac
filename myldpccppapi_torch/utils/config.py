"""Dataclass configuration objects.

Counterpart of ``myldpccppapi_tpu/utils/config.py``: the same
:class:`DecoderConfig` fields and validation.  Implementation names map
``"jnp"`` -> ``"torch"``, ``"pallas"`` -> ``"cuda"`` and
``"pallas_zlane"`` -> ``"cuda_long"``; ``"edgelist"`` keeps its name.
Configurations the port does not serve yet raise
:class:`NotImplementedError` naming the ROADMAP item that brings them,
instead of being approximated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["DecoderConfig", "check_edgelist_config"]

#: implementation names the port serves
_IMPLEMENTATIONS = ("auto", "torch", "cuda", "cuda_long", "edgelist")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})"
    )


def check_edgelist_config(cfg: "DecoderConfig") -> None:
    """The reference's refusals for the edge-list path: SCMS
    (``myldpccppapi_tpu/decoder.py:159-167``) and min-sum weights that are
    not scalars (``myldpccppapi_tpu/ops/bp_edgelist.py:149-154``)."""
    if cfg.self_correction:
        raise ValueError(
            "self_correction (SCMS) is served by the torch QC path and the "
            "short-code kernel's flooding mode (requested implementation="
            '"edgelist"); use implementation="auto", "torch", or "cuda"'
        )
    if not isinstance(cfg.normalization, (int, float)) or not isinstance(
        cfg.offset, (int, float)
    ):
        raise NotImplementedError(
            "edge-list decoding supports scalar min-sum weights only"
        )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Belief-propagation decoder configuration.

    algorithm:    "min-sum" | "sum-product" (log-domain phi transform;
                  takes no normalization/offset)
    schedule:     "layered" (TDMP) | "flooding"
    max_iters:    iteration cap (the reference C++ library uses 40)
    normalization: alpha for normalized min-sum (1.0 = plain min-sum);
                  a scalar or one value per base row (layer)
    offset:       beta for offset min-sum (0.0 = none); scalar or per layer
    early_exit:   stop when every codeword of the batch (on the CUDA
                  kernel: of the thread block) satisfies all parity checks
    implementation: "auto" | "torch" | "cuda" | "cuda_long" | "edgelist"
                  (cuda = hand-written layered kernel for short QC codes,
                  csrc/bp_layered.cu; cuda_long = hand-written layered
                  kernel for long QC codes such as 5G NR, csrc/bp_long.cu;
                  torch = plain tensor ops, any device; edgelist = the
                  generic edge-list path, ops/bp_edgelist.py, tensor ops on
                  any device, for any H; auto = for a code without block
                  structure the edge list, else on a CUDA device the first
                  kernel that serves the code, cuda then cuda_long, else an
                  error, and torch on the CPU)
    triage_iters: when > 0, decode the batch with this short budget first,
                  then re-decode only the unconverged frames at max_iters
                  (ops/triage.py; bit-identical to a single pass)
    triage_cap_frac: straggler buffer as a fraction of the batch; beyond
                  it the full batch is re-decoded
    syndrome_mode: convergence check of the long-code kernel ("cuda_long"):
                  "exact" runs the full syndrome after every sweep; "lazy"
                  runs it only for a codeword whose on-the-fly parity
                  check (the sign of the posterior each edge reads during
                  the sweep) passed on that sweep, so it latches only on
                  the exact syndrome, possibly a sweep later than "exact".
                  The torch path, like the reference's jnp path, always
                  checks exactly.
    self_correction: SCMS (Savin 2008) for min-sum flooding: a
                  variable-to-check message whose sign flips against the
                  previously sent one is erased (sent as 0)
    soft_output:  also return the [B, n] posterior LLRs, latched at each
                  frame's convergence like the bits (DecodeResult.
                  posteriors); served by the torch path and both
                  kernels (not kernel B's route), not with triage
    msg_dtype:    "float32" | "bfloat16" message storage; bf16 computes
                  each check update in f32 (ops/bp.py has the rounding
                  points of the two kernels)
    crc:          CRC-aided acceptance ("24A", "24B", "24C", "16"): a
                  frame is accepted when its syndrome AND the CRC of its
                  information block pass (DecodeResult.accepted); the
                  kernels stay syndrome-only and the Decoder wraps them
                  (ops/crc_accept.py)
    crc_span:     information bits the CRC covers (default: all of them)
    outer:        ("bch", m, t): the DVB-S2 outer BCH as the acceptance
                  check, in the same way as crc
    """

    algorithm: str = "min-sum"
    schedule: str = "layered"
    max_iters: int = 40
    normalization: "float | tuple" = 1.0
    offset: "float | tuple" = 0.0
    early_exit: bool = True
    implementation: str = "auto"
    triage_iters: int = 0
    triage_cap_frac: float = 0.125
    self_correction: bool = False
    msg_dtype: str = "float32"
    crc: Optional[str] = None
    crc_span: Optional[int] = None
    outer: Optional[Tuple[str, int, int]] = None
    soft_output: bool = False
    syndrome_mode: str = "exact"

    def __post_init__(self):
        # coerce (possibly nested) weight lists/arrays to hashable tuples
        for f in ("normalization", "offset"):
            w = getattr(self, f)
            if not isinstance(w, (int, float)):
                w = tuple(
                    x if isinstance(x, (int, float)) else tuple(x) for x in w
                )
                object.__setattr__(self, f, w)
        if self.algorithm not in ("min-sum", "sum-product"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.implementation not in _IMPLEMENTATIONS:
            raise ValueError(f"unknown implementation {self.implementation!r}")
        if self.msg_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown msg_dtype {self.msg_dtype!r}")
        if self.crc is not None:
            from ..codes.crc import CRC_POLYS

            if self.crc not in CRC_POLYS:
                raise ValueError(
                    f"unknown crc {self.crc!r}; choose from {sorted(CRC_POLYS)}")
        if self.algorithm == "sum-product" and (
            self.normalization != 1.0 or self.offset != 0.0
        ):
            raise ValueError(
                "normalization/offset are min-sum knobs; the sum-product "
                "check update has no such correction (they would be "
                "silently ignored)"
            )
        if self.syndrome_mode not in ("exact", "lazy"):
            raise ValueError(f"unknown syndrome_mode {self.syndrome_mode!r}")
        if self.self_correction and (
            self.algorithm != "min-sum" or self.schedule != "flooding"
        ):
            raise ValueError(
                "self_correction is the SCMS rule for min-sum FLOODING "
                f"(got {self.algorithm!r}/{self.schedule!r}); layered "
                "schedules have no per-iteration message memory to "
                "compare against"
            )
        if self.crc_span is not None:
            if self.crc is None:
                raise ValueError("crc_span requires crc to be set")
            if self.crc_span <= 0:
                raise ValueError(f"crc_span must be positive, got {self.crc_span}")
        if self.outer is not None and (
            len(self.outer) != 3
            or self.outer[0] != "bch"
            or not all(isinstance(x, int) for x in self.outer[1:])
        ):
            raise ValueError(f'outer must be ("bch", m, t), got {self.outer!r}')
        self._refuse_unported()
        if self.implementation == "edgelist":
            check_edgelist_config(self)

    def _refuse_unported(self):
        for f in ("normalization", "offset"):
            w = getattr(self, f)
            if not isinstance(w, (int, float)) and not all(
                isinstance(x, (int, float)) for x in w
            ):
                raise _not_ported(f"per-iteration {f} weights",
                                  "Queue 1 item 3")
