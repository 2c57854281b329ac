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
  D), which serves codes whose posterior does not fit on chip: the
  posterior in a global-memory scratch, each layer staged in shared memory
  by bulk copies, min-sum messages compressed to a record per row (the
  *global* placement, ``bp_stream.cu``, whose stage plan and launch are in
  ``ops/cuda_stream.py``): DVB-S2 64800, whose bf16 posterior would fit a
  block's shared memory but leave one block to an SM.  The TPU's D
  refuses sum-product and soft output; the global placement serves every
  mode of kernel C's sweep.

The kernel library's fit query (:func:`placement`) picks the placement from
its own shared-memory layout and the message item size: shared where as
many blocks fit an SM as the serving instantiation is built for.  Under bf16 the
wrapper casts the LLRs to bf16 on the card, the kernel stores R, P and the
posterior output in bf16 with kernel C's rounding points, and the plain
version is the torch layered decode with the same points
(``group_rounding``, ops/bp.py).  :func:`decode_qc_long` launches the kernel
for a CUDA tensor and raises if it cannot; for a CPU tensor it runs the
plain version, :func:`decode_qc_long_plain`.  There is no fallback from a
failed build or launch.  ``decode_qc_long.launches`` counts launches in the
shared placement and ``decode_qc_long.global_launches`` those in the
global one; ``decode_qc_long.soft_launches``, ``.sp_launches`` and
``.bf16_launches`` count, across placements, those with soft output, those
of sum-product and those with bf16 messages.  While a torch profiler
records, a CUDA decode shows as three consecutive spans
(``utils.profiling.span``): ``myldpc.long.prepare`` (every host step before
the library call: checks, placement, outputs, the cast, scratches, tables,
arguments), ``myldpc.long.launch`` (the library call) and
``myldpc.long.finish`` (counters, ``executed.max()``, the result).

The lazy syndrome is per codeword here: a codeword latches on a sweep only
if its on-the-fly parity check passed on that sweep and then its exact
syndrome.  The TPU kernels run the exact pass for a whole 8-codeword (C)
or 128-codeword (D) tile once any live codeword of the tile passes the
pre-check, so their iteration counts depend on the tiling; both meet the
reference's lazy contract (converged => zero syndrome; lazy iterations >=
exact iterations).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from ..utils.device import cuda_index
from ..utils.profiling import span
from . import _build
from .bp import DecodeResult, _decode_layered, layer_weights, msg_dtype, weights_mode
from . import cuda_stream
from .cuda_stream import MULTI_EDGE, group_slots, layer_flags, live_words, n_masks

__all__ = ["GLOBAL", "MIN_Z", "REQUIREMENTS", "SHARED", "blocks_per_sm",
           "decode_qc_long", "decode_qc_long_plain", "placement", "scratch_bytes",
           "supported"]

#: the reference kernel's gate (pallas_zlane.zlane_supported): below half a
#: 128-lane tile the TPU layout wastes the VPU, and small-z codes go to the
#: short-code kernels there (ops/cuda_bp.py serves kernel B's route below it)
MIN_Z = 64
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
    widest row past the kernels' bounds).
    The kernel library answers from its own layout and the device's limits,
    so this builds the kernel at first use."""
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
    do).  The flooding
    schedule, and SCMS with it, is the TPU short-code kernel's, as here
    (ops/cuda_bp.py).  So is the xor group: the kernel aligns circulants
    only, as the TPU's z-lane kernel does, so an xor-group code is refused
    whatever its class."""
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


@functools.lru_cache(maxsize=32)
def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """The kernel's tables as device arrays, cached per (code, weights,
    device) so a launch copies nothing from the host: block columns, shift
    words (shift | mask slot << 16), layer pointers, layer flags, the
    masked blocks' live-row bits, alpha and beta; and whether any layer is
    multi-edge."""
    _, bc, sh = code.blocks
    words = (code.z + 31) // 32
    shift = sh.astype(np.int32)
    live = []
    for e, mask in enumerate(code.block_row_masks):
        if mask is not None:
            live.append(live_words(mask, words))
            shift[e] |= len(live) << 16
    flags = layer_flags(code)
    alphas, betas = layer_weights(normalization, offset, code.m_b)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    live_rows = np.concatenate(live) if live else np.zeros(1, np.int32)
    tables = tuple(dev(a, np.int32)
                   for a in (bc, shift, code.layer_ptr, flags, live_rows))
    tables += (dev(alphas, np.float32), dev(betas, np.float32))
    return tables, bool((flags & MULTI_EDGE).any())


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


def _shared_args(code: QCCode, cfg: DecoderConfig, llr_k: torch.Tensor, bits, conv,
                 iters, executed, post, stream: int) -> tuple:
    """The arguments of the library's ``ldpc_bp_long`` (csrc/bp_long.cu, the
    shared placement) for a decode on checked CUDA tensors; ``llr_k`` in
    the message dtype.  Allocates the R scratch."""
    dt = llr_k.dtype
    sum_product = cfg.algorithm == "sum-product"
    # the messages R, records or per edge: written before they are read
    per_codeword = scratch_bytes(code, sum_product, dt.itemsize)
    r_scratch = torch.empty((llr_k.shape[0] * per_codeword,), dtype=torch.uint8,
                            device=llr_k.device)
    tables, multi_edge = _device_tables(code, cfg.normalization, cfg.offset, llr_k.device)
    return (
        llr_k.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
        executed.data_ptr(), None if post is None else post.data_ptr(),
        r_scratch.data_ptr(), *(t.data_ptr() for t in tables),
        llr_k.shape[0], code.n_b, code.z, code.m_b, code.num_blocks, n_masks(code),
        int(multi_edge), group_slots(code), code.max_row_degree,
        cfg.max_iters, int(cfg.early_exit), int(cfg.syndrome_mode == "lazy"),
        int(sum_product), int(dt == torch.bfloat16), stream)


def decode_qc_long(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor, *,
                   _place: int = 0) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the long-code
    kernels, one thread block per codeword, the posterior where the fit
    query places it (``_place``, :data:`SHARED` or :data:`GLOBAL`, puts it
    there instead, for tests and probes; a launch that does not fit
    raises).  Returns the same
    DecodeResult as ops/bp.py, posteriors included (in the message dtype)
    with ``cfg.soft_output``; ``total_iters`` is the largest sweep count of
    any codeword's block, which equals the batch's loop count of the
    single-loop torch path."""
    if llr.ndim != 2 or llr.shape[1] != code.n:
        raise ValueError(f"expected llr of shape [batch, {code.n}], got "
                         f"{tuple(llr.shape)}")
    if llr.dtype != torch.float32:
        raise ValueError(f"expected float32 llr, got {llr.dtype}")
    if llr.device.type == "cpu":
        return decode_qc_long_plain(code, cfg, llr)
    with span("long.prepare"):
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        if not supported(code, cfg, llr.device):
            raise ValueError(
                f"the CUDA long-code kernel does not serve {code.name} under "
                f"this config: it needs {REQUIREMENTS}"
            )
        dt = msg_dtype(cfg)
        place = _place or placement(code, cuda_index(llr.device), msg_dtype(cfg).itemsize)
        batch = llr.shape[0]
        dev = llr.device
        bits = torch.empty((batch, code.n), dtype=torch.uint8, device=dev)
        conv = torch.empty((batch,), dtype=torch.bool, device=dev)
        iters = torch.empty((batch,), dtype=torch.int32, device=dev)
        post = (torch.empty((batch, code.n), dtype=dt, device=dev)
                if cfg.soft_output else None)
        if batch == 0:
            return DecodeResult(bits, conv, iters,
                                torch.zeros((), dtype=torch.int32, device=dev),
                                posteriors=post)
        llr_k = llr.to(dt)  # bf16: cast on the card (the reference casts first)
        executed = torch.empty((batch,), dtype=torch.int32, device=dev)
        sum_product = cfg.algorithm == "sum-product"
        stream = torch.cuda.current_stream(dev).cuda_stream
        operands = (code, cfg, llr_k, bits, conv, iters, executed, post, stream)
        if place == GLOBAL:
            name, args = "ldpc_bp_stream", cuda_stream.launch_args(*operands)
        else:
            name, args = "ldpc_bp_long", _shared_args(*operands)
    with torch.cuda.device(dev):
        cuda_stream.launch(name, args)
    with span("long.finish"):
        if place == GLOBAL:
            decode_qc_long.global_launches += 1
        else:
            decode_qc_long.launches += 1
        decode_qc_long.soft_launches += post is not None
        decode_qc_long.sp_launches += sum_product
        decode_qc_long.bf16_launches += dt == torch.bfloat16
        return DecodeResult(bits, conv, iters, executed.max(), posteriors=post)


decode_qc_long.launches = 0
decode_qc_long.global_launches = 0
decode_qc_long.soft_launches = 0
decode_qc_long.sp_launches = 0
decode_qc_long.bf16_launches = 0
