"""Wrapper of the hand-written long-code layered BP kernels
(``csrc/bp_long.cu`` and ``csrc/bp_stream.cu``).

Counterpart of two TPU kernels, which compute one function in two
placements of the posterior:

* ``myldpccppapi_tpu/ops/pallas_zlane.py`` (``decode_qc_zlane``, kernel C)
  in its layered modes, f32 or bf16 messages: min-sum or sum-product,
  single-circulant and multi-edge cells, row-masked partial circulants, the
  exact or the lazy syndrome, soft output (the latched posterior).  The
  posterior lives in a thread block's shared memory (the *shared*
  placement, ``bp_long.cu``): 5G NR, DVB-S2 16200; min-sum messages are
  one record per row and layer in a device-memory scratch whose size the
  kernel library gives (:func:`scratch_bytes`).
* ``myldpccppapi_tpu/ops/pallas_stream.py`` (``decode_qc_stream``, kernel
  D), for codes whose posterior does not fit on chip: the *global*
  placement (``bp_stream.cu``, host side in ``ops/cuda_stream.py``), DVB-S2
  64800.  The TPU's D refuses sum-product and soft output; the global
  placement serves every mode of kernel C's sweep.

The kernel library's fit query (:func:`placement`) picks the placement from
its own shared-memory layout and the message item size: shared where as
many blocks fit an SM as the serving instantiation is built for.  Under bf16 the
wrapper casts the LLRs to bf16 on the card, the kernel stores R, P and the
posterior output in bf16 with kernel C's rounding points, and the plain
version is the torch layered decode with the same points
(``group_rounding``, ops/bp.py).  :func:`plan` resolves a launch once per
(code, config, device, placement), and ``ops/cuda_launch.py`` launches it.
:func:`decode_qc_long` launches the kernel for a CUDA tensor and raises if
it cannot (there is no fallback); for a CPU tensor it runs the plain
version, :func:`decode_qc_long_plain`.  ``decode_qc_long.launches`` and
``.global_launches`` count launches in the shared and the global placement;
``.soft_launches``, ``.sp_launches`` and ``.bf16_launches``, across
placements, those with soft output, of sum-product and with bf16 messages.

The lazy syndrome is per codeword here: a codeword latches on a sweep only
if its on-the-fly parity check passed on that sweep and then its exact
syndrome.  The TPU kernels run the exact pass for a whole 8-codeword (C)
or 128-codeword (D) tile once any live codeword of the tile passes the
pre-check, so their iteration counts depend on the tiling; both meet the
reference's lazy contract (converged => zero syndrome; lazy iterations >=
exact iterations).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from ..utils.device import cuda_index, indexed
from . import _build, cuda_launch, cuda_stream
from .bp import DecodeResult, _decode_layered, layer_weights, msg_dtype, weights_mode
from .cuda_launch import (MIN_Z, MULTI_EDGE, dev, group_slots, layer_flags, live_rows,
                          mask_slots, n_masks)

__all__ = ["GLOBAL", "MIN_Z", "REQUIREMENTS", "SHARED", "Plan", "blocks_per_sm",
           "decode_qc_long", "decode_qc_long_plain", "placement", "plan", "scratch_bytes",
           "supported"]

#: posterior placements, as the kernel library's fit query reports them
SHARED, GLOBAL = 2, 1
#: what :func:`supported` asks of a code and a config, for error messages;
#: the kernel's own bounds stay in csrc/bp_long.cu, behind its fit query
REQUIREMENTS = (
    f"a QCCode (cyclic circulants) with z >= {MIN_Z} that the kernel library's fit query "
    "accepts (z threads per block and the widest row within the kernel's "
    "bounds, its tables within a thread block's shared memory), the "
    "layered schedule (min-sum or sum-product, soft output or not, f32 or "
    "bf16 messages), scalar or per-layer min-sum weights, not a "
    "per-iteration schedule (the torch path serves that); CRC or "
    "outer-code acceptance wraps it (Decoder)"
)


@functools.lru_cache(maxsize=64)
def placement(code: QCCode, device_index: int, itemsize: int = 4) -> int:
    """Where the kernel keeps ``code``'s posterior on CUDA device
    ``device_index`` with ``itemsize``-byte messages (4 f32, 2 bf16):
    :data:`SHARED` when it fits a thread block's shared memory with the
    tables, :data:`GLOBAL` when only the global kernel's stage ring and
    tables do, 0 when neither kernel can serve the code (z threads or the
    widest row past the kernels' bounds).  The kernel library answers from
    its own layout and the device's limits, so this builds the kernel at
    first use."""
    got = _build.load().ldpc_bp_long_fits(
        code.n, code.z, code.m_b, code.num_blocks, n_masks(code),
        group_slots(code), code.max_row_degree, itemsize, device_index)
    if got < 0:
        raise RuntimeError(f"bp_long fit query failed: CUDA error {-got}")
    return got


def blocks_per_sm(code: QCCode, cfg: DecoderConfig, place: int) -> int:
    """Thread blocks of the kernel that one SM of the current device holds
    at once for ``code`` under ``cfg`` in placement ``place`` (the
    occupancy of the instantiation that serves them, with cfg's message
    item size)."""
    sum_product = cfg.algorithm == "sum-product"
    if place == GLOBAL:
        return cuda_stream.blocks_per_sm(code, sum_product, msg_dtype(cfg).itemsize)
    got = _build.load().ldpc_bp_long_blocks_per_sm(
        code.n, code.z, code.m_b, code.num_blocks, n_masks(code),
        int((layer_flags(code) & MULTI_EDGE).any()), group_slots(code),
        code.max_row_degree, int(cfg.syndrome_mode == "lazy"),
        int(sum_product), msg_dtype(cfg).itemsize)
    if got < 1:
        raise RuntimeError(f"bp_long occupancy query returned {got}")
    return got


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for a QC code with z >= 64 (multi-edge cells and masked rows
    included) and, when ``cfg`` is given, for the layered configurations
    the kernel serves: min-sum or sum-product, soft output or not, the
    exact or the lazy syndrome, f32 or bf16 messages.  When a CUDA
    ``device`` is given, the kernel must serve the code there in one of
    its placements (:func:`placement`).

    Refused: a config with CRC or outer-code acceptance (the kernel is
    syndrome-only; ``Decoder`` wraps it, ops/crc_accept.py), and a
    per-iteration weight schedule in either placement (the tables hold one
    weight per layer, as ``pallas_zlane``'s and ``pallas_stream.py:77-83``
    do).  The flooding schedule, and SCMS with it, is the TPU short-code
    kernel's, as here (ops/cuda_bp.py).  So is the xor group: the kernel
    aligns circulants only, as the TPU's z-lane kernel does, so an
    xor-group code is refused whatever its class."""
    if getattr(code, "group", "cyclic") == "xor":
        return False
    if not isinstance(code, QCCode) or code.z < MIN_Z:
        return False
    if cfg is not None and not (
            cfg.schedule == "layered" and cfg.crc is None and cfg.outer is None
            and weights_mode(cfg, code.m_b) != "iter"):
        return False
    return (device is None
            or placement(code, cuda_index(device), msg_dtype(cfg).itemsize) > 0)


def decode_qc_long_plain(code: QCCode, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch layered decode (ops/bp.py),
    min-sum or sum-product, with the latched posterior under soft output,
    whose JAX counterpart the reference pins bit-exact to the TPU kernel
    in f32 (tests/test_zlane.py); with ``syndrome_mode="lazy"`` its lazy
    loop, where a frame latches only on a sweep whose on-the-fly parity
    check passed; under bf16 kernel C's rounding points.  The placement
    does not change the function."""
    return _decode_layered(code, cfg, llr, lazy=cfg.syndrome_mode == "lazy",
                           group_rounding=True)


def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """The kernel's tables as device arrays (a plan's tables, so that a
    launch copies nothing from the host): block columns, shift
    words (shift | mask slot << 16), layer pointers, layer flags, the
    masked blocks' live-row bits, alpha and beta."""
    _, bc, sh = code.blocks
    shift = sh | mask_slots(code) << 16
    alphas, betas = layer_weights(normalization, offset, code.m_b)
    return (*(dev(a, np.int32, device) for a in (bc, shift, code.layer_ptr, layer_flags(code),
                                                  live_rows(code))),
            dev(alphas, np.float32, device), dev(betas, np.float32, device))


@functools.lru_cache(maxsize=64)
def scratch_bytes(code: QCCode, sum_product: bool, itemsize: int) -> int:
    """Bytes of one codeword's messages in the shared placement's scratch,
    as the kernel library lays them out: min-sum records (``record.cuh``,
    ``[m_b, record words, z]`` 32-bit words), or sum-product's
    ``[num_blocks, z]`` messages.  The kernel reads and writes them once a
    sweep."""
    got = _build.load().ldpc_bp_long_scratch_bytes(
        code.z, code.m_b, code.num_blocks, code.max_row_degree, int(sum_product), itemsize)
    if got < 1:
        raise RuntimeError(f"bp_long scratch query returned {got}")
    return got


@dataclasses.dataclass(frozen=True, eq=False)
class Plan(cuda_launch.Plan):
    """Kernel C's launches in the shared placement (:func:`plan`):
    ``ints``, ``ldpc_bp_long``'s integer arguments after the batch."""

    kind, entry = "long", "ldpc_bp_long"
    device_tables = staticmethod(_device_tables)

    ints: tuple

    def args(self, outs, llr_k, tile, stream) -> tuple:
        """Allocates the R scratch."""
        # the messages R, records or per edge: written before they are read
        per_codeword = scratch_bytes(self.code, self.cfg.algorithm == "sum-product",
                                     llr_k.dtype.itemsize)
        r_scratch = torch.empty((llr_k.shape[0] * per_codeword,), dtype=torch.uint8,
                                device=llr_k.device)
        return (*outs, r_scratch.data_ptr(), *(t.data_ptr() for t in self.tables),
                llr_k.shape[0], *self.ints, stream)


def plan(code: QCCode, cfg: DecoderConfig, device, place: int = 0) -> cuda_launch.Plan:
    """The plan for ``code`` under ``cfg`` on CUDA ``device`` (the current
    device where it names none) in the placement of the fit query
    (:func:`placement`) or ``place``, made once: kernel C's :class:`Plan`
    (shared) or kernel D's (global); ValueError where :func:`supported`
    refuses it."""
    return _plan(code, cfg, indexed(device), place)


@functools.lru_cache(maxsize=64)
def _plan(code: QCCode, cfg: DecoderConfig, device: torch.device,
          place: int) -> cuda_launch.Plan:
    if not supported(code, cfg, device):
        raise ValueError(
            f"the CUDA long-code kernel does not serve {code.name} under "
            f"this config: it needs {REQUIREMENTS}")
    dt = msg_dtype(cfg)
    sum_product = cfg.algorithm == "sum-product"
    place = place or placement(code, cuda_index(device), dt.itemsize)
    counts = tuple(name for name, on in (
        ("global_launches" if place == GLOBAL else "launches", True),
        ("soft_launches", cfg.soft_output), ("sp_launches", sum_product),
        ("bf16_launches", dt == torch.bfloat16)) if on)
    if place == GLOBAL:
        return cuda_stream.plan(code, cfg, device, decode_qc_long, counts)
    return Plan(code, cfg, device, decode_qc_long, counts,
                (code.n_b, code.z, code.m_b, code.num_blocks, n_masks(code),
                 int((layer_flags(code) & MULTI_EDGE).any()), group_slots(code),
                 code.max_row_degree, cfg.max_iters, int(cfg.early_exit),
                 int(cfg.syndrome_mode == "lazy"), int(sum_product),
                 int(dt == torch.bfloat16)))


def decode_qc_long(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor, *,
                   _place: int = 0) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the long-code
    kernels, one thread block per codeword, the posterior where the fit
    query places it or in ``_place`` (for tests and probes; a launch that
    does not fit raises).  Returns the same DecodeResult as ops/bp.py,
    posteriors included (in the message dtype) with ``cfg.soft_output``;
    ``total_iters`` is the largest sweep count of any codeword's block, the
    batch's loop count of the single-loop torch path."""
    if cuda_launch.check_llr(code, llr):
        return decode_qc_long_plain(code, cfg, llr)
    return cuda_launch.decode("long", lambda: plan(code, cfg, cuda_launch.card(llr), _place),
                              llr)


decode_qc_long.launches = 0
decode_qc_long.global_launches = 0
decode_qc_long.soft_launches = 0
decode_qc_long.sp_launches = 0
decode_qc_long.bf16_launches = 0
