"""Wrapper of the hand-written long-code layered BP kernel
(``csrc/bp_long.cu``).

Counterpart of two TPU kernels, served as modes of one CUDA sweep:

* ``myldpccppapi_tpu/ops/pallas_zlane.py`` (``decode_qc_zlane``, kernel C)
  in its layered modes, f32 or bf16 messages: min-sum or sum-product,
  single-circulant and multi-edge cells, row-masked partial circulants, the
  exact or the lazy syndrome, soft output (the latched posterior).  The
  posterior lives in a thread block's shared memory (the *shared*
  placement): 5G NR, DVB-S2 16200.
* ``myldpccppapi_tpu/ops/pallas_stream.py`` (``decode_qc_stream``, kernel
  D), which serves codes whose posterior does not fit on chip: the same
  sweep with the posterior in a [B, n] global-memory scratch that this
  wrapper allocates (the *global* placement): DVB-S2 64800, whose bf16
  posterior would fit a block's shared memory but leave one block to an
  SM where the global placement runs two.  The TPU's D
  refuses sum-product and soft output; the global placement runs C's sweep,
  so it serves them as C does.

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
of sum-product and those with bf16 messages.

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
from . import _build
from .bp import DecodeResult, _decode_layered, layer_weights, msg_dtype

__all__ = ["GLOBAL", "MIN_Z", "REQUIREMENTS", "SHARED", "blocks_per_sm",
           "decode_qc_long", "decode_qc_long_plain", "placement", "supported"]

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
    "bf16 messages); CRC or outer-code acceptance wraps it (Decoder)"
)


def _n_masks(code: QCCode) -> int:
    return sum(m is not None for m in code.block_row_masks)


@functools.lru_cache(maxsize=64)
def placement(code: QCCode, device_index: int, itemsize: int = 4) -> int:
    """Where the kernel keeps ``code``'s posterior on CUDA device
    ``device_index`` with ``itemsize``-byte messages (4 f32, 2 bf16):
    :data:`SHARED` when it fits a thread block's shared memory with the
    tables, :data:`GLOBAL` when only the tables do, 0 when the kernel cannot
    serve the code (z threads or the widest row past the kernel's bounds).
    The kernel library answers from its own layout and the device's limits,
    so this builds the kernel at first use."""
    got = _build.load().ldpc_bp_long_fits(
        code.n, code.z, code.m_b, code.num_blocks, _n_masks(code),
        _group_slots(code), code.max_row_degree, itemsize, device_index)
    if got < 0:
        raise RuntimeError(f"bp_long fit query failed: CUDA error {-got}")
    return got


def blocks_per_sm(code: QCCode, cfg: DecoderConfig, place: int) -> int:
    """Thread blocks of the kernel that one SM of the current device holds
    at once for ``code`` under ``cfg`` in placement ``place`` (the
    occupancy of the instantiation that serves them, with cfg's message
    item size)."""
    got = _build.load().ldpc_bp_long_blocks_per_sm(
        code.n, code.z, code.m_b, code.num_blocks, _n_masks(code),
        int((_layer_flags(code) & _MULTI_EDGE).any()), _group_slots(code),
        code.max_row_degree, int(cfg.syndrome_mode == "lazy"),
        int(cfg.algorithm == "sum-product"), msg_dtype(cfg).itemsize, place)
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
    syndrome-only; ``Decoder`` wraps it, ops/crc_accept.py).  The flooding
    schedule, and SCMS with it, is the TPU short-code kernel's, as here
    (ops/cuda_bp.py).  So is the xor group: the kernel aligns circulants
    only, as the TPU's z-lane kernel does, so an xor-group code is refused
    whatever its class."""
    if getattr(code, "group", "cyclic") == "xor":
        return False
    if not isinstance(code, QCCode) or code.z < MIN_Z:
        return False
    if cfg is not None and not (
            cfg.schedule == "layered" and cfg.crc is None and cfg.outer is None):
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


#: layer flag bits, as the kernel reads them
_MULTI_EDGE, _HAS_MASK = 1, 2


def _layer_flags(code: QCCode) -> np.ndarray:
    """[m_b] int32: _MULTI_EDGE where two circulants share a (layer, column)
    cell (they are adjacent in block order, QCCode.blocks), _HAS_MASK where
    the layer has a row-masked block."""
    _, bc, _ = code.blocks
    masks = code.block_row_masks
    ptr = code.layer_ptr
    flags = np.zeros(code.m_b, dtype=np.int32)
    for i in range(code.m_b):
        cols = bc[ptr[i]:ptr[i + 1]]
        if len(np.unique(cols)) < len(cols):
            flags[i] |= _MULTI_EDGE
        if any(masks[e] is not None for e in range(ptr[i], ptr[i + 1])):
            flags[i] |= _HAS_MASK
    return flags


@functools.lru_cache(maxsize=64)
def _group_slots(code: QCCode) -> int:
    """Circulants of multi-edge cells (adjacent blocks of one layer and
    column) in the layer that has the most: the rows of the kernel's
    shared delta table."""
    _, bc, _ = code.blocks
    ptr = code.layer_ptr
    most = 0
    for i in range(code.m_b):
        cols = bc[ptr[i]:ptr[i + 1]]
        same = cols[1:] == cols[:-1]
        grouped = np.zeros(len(cols), dtype=bool)
        grouped[1:] |= same
        grouped[:-1] |= same
        most = max(most, int(grouped.sum()))
    return most


def _live_words(mask: np.ndarray, words: int) -> np.ndarray:
    """bool[z] live rows -> [words] int32 bit words (bit r of word w is row
    32 w + r), as the kernel reads them."""
    bits = np.zeros(words * 32, dtype=bool)
    bits[:len(mask)] = mask
    return np.packbits(bits, bitorder="little").view("<u4").view(np.int32)


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
            live.append(_live_words(mask, words))
            shift[e] |= len(live) << 16
    flags = _layer_flags(code)
    alphas, betas = layer_weights(normalization, offset, code.m_b)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    live_rows = np.concatenate(live) if live else np.zeros(1, np.int32)
    tables = tuple(dev(a, np.int32)
                   for a in (bc, shift, code.layer_ptr, flags, live_rows))
    tables += (dev(alphas, np.float32), dev(betas, np.float32))
    return tables, bool((flags & _MULTI_EDGE).any())


def decode_qc_long(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor, *,
                   _place: int = 0) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the long-code
    kernel, one thread block per codeword, the posterior where the fit
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
    # the messages R [batch, num_blocks, z] and, in the global placement,
    # the posterior P [batch, n]: written by the kernel before it reads
    # them, so left uninitialised
    r_scratch = torch.empty((batch, code.num_blocks, code.z), dtype=dt, device=dev)
    p_scratch = (torch.empty((batch, code.n), dtype=dt, device=dev)
                 if place == GLOBAL else None)
    tables, multi_edge = _device_tables(code, cfg.normalization, cfg.offset, dev)
    col, shift, ptr, flags, live_rows, alpha, beta = tables
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sum_product = cfg.algorithm == "sum-product"
        err = lib.ldpc_bp_long(
            llr_k.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), None if post is None else post.data_ptr(),
            r_scratch.data_ptr(),
            None if p_scratch is None else p_scratch.data_ptr(),
            col.data_ptr(), shift.data_ptr(), ptr.data_ptr(), flags.data_ptr(),
            live_rows.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            batch, code.n_b, code.z, code.m_b, code.num_blocks, _n_masks(code),
            int(multi_edge), _group_slots(code), code.max_row_degree,
            cfg.max_iters, int(cfg.early_exit), int(cfg.syndrome_mode == "lazy"),
            int(sum_product), int(dt == torch.bfloat16), place, stream,
        )
    if err != 0:
        raise RuntimeError(f"bp_long kernel launch failed: CUDA error {err}")
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
