"""High-level decoder facade.

Counterpart of ``myldpccppapi_tpu/decoder.py``: construction resolves the
implementation, on a kernel its launch plan (``ops/cuda_launch.py``), and
wires the decode callable once; calls then decode arbitrary batches on the
decoder's device.

The device defaults to the card (``"cuda"``: the card current at
construction, whose tables and SMs a kernel's plan holds); without CUDA
that raises, and ``device="cpu"`` is the only way onto the CPU.

Dispatch, in the reference's order (``myldpccppapi_tpu/decoder.py::
_implementation``): a code without block structure (any object exposing
``n``, ``m`` and ``h_coo()``, such as the DVB-S2 standard-domain oracle
``dvbs2_oracle``) resolves ``"auto"`` to the generic edge-list path
(``"edgelist"``, ops/bp_edgelist.py: tensor ops on the decoder's device,
as the reference's are XLA ops) on every device; an explicit
``"edgelist"`` serves the QC and RS-LDPC codes too, a layer per block
row.  For the port's block codes, on a CUDA device ``"auto"`` resolves to
the short-code kernel (``"cuda"``, ops/cuda_bp.py) when its
``supported(code, cfg, device)`` admits the request, else to the
long-code kernel (``"cuda_long"``, ops/cuda_long.py) when its gate does,
else to the torch path (``"torch"``: ops/bp.py, tensor ops on the card),
which is where the reference sends a request its Pallas kernels refuse
to its jnp path (XLA ops on the same device).  The choice is made from
the gates before any launch and is reported in :attr:`Decoder.implementation`;
a kernel that fails to build or launch raises, it is never replaced.

What each kernel serves is its module's ``REQUIREMENTS``.  The torch path
serves on the card what neither admits, as the reference's jnp path does on
its device: per-iteration (learned) weight schedules; RS-LDPC codes whose
state does not fit a thread block (``rs_ldpc_from_n(8192)``); soft output,
sum-product, per-layer weights and SCMS on NR with z < 64; and flooding,
SCMS and flooding sum-product on the long codes.  The table differs from
the TPU's in two places, each where the port's kernel serves more (named in
tests/test_torch_dispatch_parity.py): kernel B's route takes the small-z NR
layered min-sum that the reference gives its streaming kernel, in f32 and
in bf16, which that kernel refuses.

An explicit ``"cuda"`` or ``"cuda_long"`` that does not serve the code
raises at construction, as the reference's explicit ``"pallas"`` does.
On the CPU, ``"auto"`` resolves to ``"torch"``.  An explicit ``"torch"``
runs the plain tensor path on any device; like the reference's jnp path
it checks the exact syndrome whatever ``syndrome_mode`` says.

Both kernels serve f32 and bf16 messages (``msg_dtype``), as their TPU
counterparts do.  They stay syndrome-only: with ``crc`` or ``outer`` set,
dispatch asks them for the config without its check, and the decode (with
its triage) is wrapped in the acceptance wrapper (ops/crc_accept.py,
``myldpccppapi_tpu/decoder.py:204-213,282-305``), whose retry is the
kernel's plain version with the check in its latch, exact syndrome, on
the same device.  The torch and edge-list paths run the check in their
own latch, unwrapped.  Under triage both passes take the route that
dispatch chose, as the reference builds them.

Refused at construction, as the reference refuses them: soft output with
triage (the two-phase wrapper merges hard outputs only), SCMS on the
long-code kernel and on the edge list, and min-sum weights that are not
scalars on the edge list.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from .codes.qc import QCCode
from .codes.rs_ldpc import RSLDPCCode
from .ops import cuda_bp, cuda_launch, cuda_long
from .ops.bitflip import GDBFConfig, decode_gdbf
from .ops.bp import DecodeResult, accept_fail_fn, decode_qc
from .ops.bp_edgelist import build_edge_index, decode_edgelist
from .ops.crc_accept import decode_with_crc_accept
from .ops.triage import decode_two_phase
from .utils.config import DecoderConfig, check_edgelist_config
from .utils.device import DEFAULT_DEVICE, indexed, resolve_device
from .utils.profiling import span

__all__ = ["Decoder", "DecodeResult", "resolve_device"]


#: the kernels by implementation name, in auto-dispatch order
_KERNELS = {"cuda": cuda_bp, "cuda_long": cuda_long}


def _syndrome_only(cfg: DecoderConfig) -> DecoderConfig:
    """``cfg`` without its acceptance check: what a kernel runs under the
    acceptance wrapper."""
    return dataclasses.replace(cfg, crc=None, crc_span=None, outer=None)


def _implementation(code, cfg: DecoderConfig, device: torch.device) -> str:
    impl = cfg.implementation
    cfg = _syndrome_only(cfg)
    if not isinstance(code, (QCCode, RSLDPCCode)):
        if hasattr(code, "blocks"):
            raise TypeError(
                f"{type(code).__name__} is not one of the port's block codes "
                "(QCCode, RSLDPCCode); carry a reference code across with "
                "interop.code_from_reference")
        if impl not in ("auto", "edgelist"):
            raise ValueError(
                f"{code.name} has no block structure: only the edge-list path "
                f"decodes it (implementation=\"auto\" or \"edgelist\", not {impl!r})")
        return "edgelist"
    if impl == "edgelist":
        return impl
    if impl == "torch" or (impl == "auto" and device.type != "cuda"):
        return "torch"
    if device.type != "cuda":
        raise ValueError(
            f"implementation={impl!r} runs on a CUDA device; got device="
            f"{device}"
        )
    if impl == "auto":
        for name, kernel in _KERNELS.items():
            if kernel.supported(code, cfg, device):
                return name
        # neither kernel's gate admits it: the reference's jnp route, here
        # torch ops on the card
        return "torch"
    if not _KERNELS[impl].supported(code, cfg, device):
        raise ValueError(
            f"the {impl!r} kernel does not serve {code.name} under this "
            f"config: it needs {_KERNELS[impl].REQUIREMENTS}; use "
            "implementation=\"auto\" (the torch path where no kernel "
            "serves) or \"torch\"")
    return impl


class Decoder:
    """Batched LDPC decoder bound to one code, one configuration and one
    device: a :class:`QCCode` or :class:`RSLDPCCode` (block paths and the
    kernels), or any object exposing ``n``, ``m`` and ``h_coo()`` (the
    edge-list path).

    A :class:`~.ops.bitflip.GDBFConfig` in place of the DecoderConfig
    takes the bit-flipping tier (``implementation == "gdbf"``,
    ops/bitflip.py: torch ops on the decoder's device, block codes only),
    with the fixed perturbation seed of the reference's facade; call
    ``ops.bitflip.decode_gdbf`` with a generator for fresh noise per batch.

    >>> dec = Decoder(wimax(576, "3/4B"), DecoderConfig())  # on the card
    >>> result = dec(llr)          # llr: [B, n] float, positive => bit 0
    >>> info = dec.info_bits(result)
    """

    def __init__(self, code, config: "DecoderConfig | GDBFConfig | None" = None, *,
                 device=DEFAULT_DEVICE, **overrides):
        if config is None:
            config = DecoderConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        device = indexed(resolve_device(device))
        if isinstance(config, GDBFConfig):
            if not hasattr(code, "blocks"):
                raise ValueError(
                    "GDBF runs on block-structured (QC / XOR-group) codes; "
                    "use a BP DecoderConfig for edge-list codes"
                )
            if not isinstance(code, (QCCode, RSLDPCCode)):
                raise TypeError(
                    f"{type(code).__name__} is not one of the port's block codes "
                    "(QCCode, RSLDPCCode); carry a reference code across with "
                    "interop.code_from_reference")
            self.code, self.config, self.device = code, config, device
            self.implementation = "gdbf"
            self._fn = partial(decode_gdbf, code, config)
            return
        if config.soft_output and config.triage_iters > 0:
            raise ValueError(
                "soft_output + triage is not supported: the two-phase "
                "wrapper merges hard outputs only"
            )
        if config.self_correction and config.implementation == "cuda_long":
            raise ValueError(
                "self_correction (SCMS) is served by the torch path and the "
                "short-code kernel's flooding mode (requested "
                'implementation="cuda_long"); use implementation="auto", '
                '"torch", or "cuda"'
            )
        self.code = code
        self.config = config
        self.device = device
        impl = _implementation(code, config, device)
        if impl == "edgelist":
            check_edgelist_config(config)
        #: what actually runs: "cuda" or "cuda_long" (a kernel), "torch" or
        #: "edgelist"
        self.implementation = impl
        self._edge_idx = None
        self._fn = self._build_fn(config)
        if config.triage_iters > 0:
            self._fn = self._make_triage()
        if (config.crc or config.outer) and impl in _KERNELS:
            self._fn = self._make_crc_accept()

    def _edge_index(self):
        """The code's edge tables: its own ``edge_index`` where it has one
        (the DVB-S2 oracle's mod-q layers), else built from ``h_coo()``
        with a layer per block row (``arange(m) // z``) where the code has
        a ``z``, one layer otherwise."""
        if self._edge_idx is None:
            idx = getattr(self.code, "edge_index", None)
            if idx is None:
                rows, cols = self.code.h_coo()
                layer = (np.arange(self.code.m, dtype=np.int32) // self.code.z
                         if hasattr(self.code, "z") else None)
                idx = build_edge_index(rows, cols, self.code.n, self.code.m, layer)
            self._edge_idx = idx
        return self._edge_idx

    def _build_fn(self, cfg: DecoderConfig):
        if self.implementation == "edgelist":
            # the check runs in the edge list's own latch
            return partial(decode_edgelist, self._edge_index(), cfg,
                           crc_fail=accept_fail_fn(self.code, cfg))
        if self.implementation in _KERNELS:
            # the kernel's plan, resolved once: a call launches it
            return partial(cuda_launch.launch, _KERNELS[self.implementation].plan(
                self.code, _syndrome_only(cfg), self.device))
        # the torch path runs cfg's acceptance check in its own latch
        return partial(decode_qc, self.code, cfg)

    def _make_triage(self):
        """Wrap the decoder in the two-phase straggler triage
        (ops/triage.py): fast short pass, then full-budget re-decode of the
        compacted unconverged frames.  Bit-identical to a single pass."""
        cfg = self.config
        fast = self._build_fn(dataclasses.replace(
            cfg, max_iters=cfg.triage_iters, triage_iters=0))
        full = self._build_fn(dataclasses.replace(cfg, triage_iters=0))

        def fn(llr):
            cap = max(8, int(llr.shape[0] * cfg.triage_cap_frac))
            if cap >= llr.shape[0]:
                return full(llr)
            return decode_two_phase(fast, full, llr, cap)

        return fn

    def _make_crc_accept(self):
        """Wrap the (kernel, possibly triage-wrapped) decode in CRC- /
        outer-code-aided acceptance (ops/crc_accept.py): syndrome-converged
        frames that fail the check are re-decoded at the full budget by
        the kernel's plain version with the check in its latch and the
        exact syndrome (kernel C's under its own bf16 rounding points)."""
        cfg = self.config
        fail = accept_fail_fn(self.code, cfg)
        retry_cfg = dataclasses.replace(cfg, implementation="torch",
                                        triage_iters=0, syndrome_mode="exact")
        if self.implementation == "cuda_long":
            retry_full = partial(cuda_long.decode_qc_long_plain, self.code, retry_cfg)
        else:
            retry_full = partial(cuda_bp.decode_qc_cuda_plain, self.code, retry_cfg)
        inner = self._fn

        def fn(llr):
            cap = max(8, int(llr.shape[0] * cfg.triage_cap_frac))
            return decode_with_crc_accept(inner, retry_full, fail, llr, cap)

        return fn

    def __call__(self, llr) -> DecodeResult:
        """Decode [B, n] LLRs (a tensor or array; moved to the decoder's
        device as float32).  While a torch profiler records, the call is
        the span ``myldpc.decode`` (``utils.profiling.span``)."""
        with span("decode"):
            llr = torch.as_tensor(llr, dtype=torch.float32, device=self.device)
            if llr.ndim != 2 or llr.shape[-1] != self.code.n:
                raise ValueError(
                    f"expected llr of shape [batch, {self.code.n}], got "
                    f"{tuple(llr.shape)}"
                )
            return self._fn(llr.contiguous())

    def info_bits(self, result: DecodeResult) -> torch.Tensor:
        """Information bits of the decoded codewords: [B, k_info]."""
        if isinstance(self.code, QCCode) and self.code.info_cols is None:
            return result.bits[:, : self.code.k]
        pos = torch.as_tensor(self.code.info_positions, device=result.bits.device)
        return result.bits[:, pos]
