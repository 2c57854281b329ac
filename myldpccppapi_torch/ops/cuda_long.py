"""Wrapper of the hand-written long-code layered BP kernel
(``csrc/bp_long.cu``).

Counterpart of two TPU kernels, served as modes of one CUDA sweep:

* ``myldpccppapi_tpu/ops/pallas_zlane.py`` (``decode_qc_zlane``, kernel C)
  in its layered min-sum f32 mode: single-circulant and multi-edge cells,
  row-masked partial circulants, the exact or the lazy syndrome.  The
  posterior lives in a thread block's shared memory (the *shared*
  placement): 5G NR, DVB-S2 16200.
* ``myldpccppapi_tpu/ops/pallas_stream.py`` (``decode_qc_stream``, kernel
  D), which serves codes whose posterior does not fit on chip: the same
  sweep with the posterior in a [B, n] global-memory scratch that this
  wrapper allocates (the *global* placement): DVB-S2 64800.

The kernel library's fit query (:func:`placement`) picks the placement from
its own shared-memory layout.  :func:`decode_qc_long` launches the kernel
for a CUDA tensor and raises if it cannot; for a CPU tensor it runs the
plain version, :func:`decode_qc_long_plain`.  There is no fallback from a
failed build or launch.  ``decode_qc_long.launches`` counts launches in the
shared placement and ``decode_qc_long.global_launches`` those in the
global one.

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
from .bp import DecodeResult, _decode_layered, layer_weights

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
    f"a QCCode with z >= {MIN_Z} that the kernel library's fit query "
    "accepts (z threads per block and the widest row within the kernel's "
    "bounds, its tables within a thread block's shared memory), and "
    "layered min-sum f32"
)


def _n_masks(code: QCCode) -> int:
    return sum(m is not None for m in code.block_row_masks)


@functools.lru_cache(maxsize=64)
def placement(code: QCCode, device_index: int) -> int:
    """Where the kernel keeps ``code``'s posterior on CUDA device
    ``device_index``: :data:`SHARED` when it fits a thread block's shared
    memory with the tables, :data:`GLOBAL` when only the tables do, 0 when
    the kernel cannot serve the code (z threads or the widest row past the
    kernel's bounds).  The kernel library answers from its own layout and
    the device's limits, so this builds the kernel at first use."""
    got = _build.load().ldpc_bp_long_fits(
        code.n, code.z, code.m_b, code.num_blocks, _n_masks(code),
        code.max_row_degree, device_index)
    if got < 0:
        raise RuntimeError(f"bp_long fit query failed: CUDA error {-got}")
    return got


def blocks_per_sm(code: QCCode, cfg: DecoderConfig, place: int) -> int:
    """Thread blocks of the kernel that one SM of the current device holds
    at once for ``code`` under ``cfg`` in placement ``place`` (the
    occupancy of the instantiation that serves them)."""
    got = _build.load().ldpc_bp_long_blocks_per_sm(
        code.n, code.z, code.m_b, code.num_blocks, _n_masks(code),
        int((_layer_flags(code) & _MULTI_EDGE).any()), code.max_row_degree, int(cfg.syndrome_mode == "lazy"),
        place)
    if got < 1:
        raise RuntimeError(f"bp_long occupancy query returned {got}")
    return got


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for a QC code with z >= 64 (multi-edge cells and masked rows
    included) and, when ``cfg`` is given, for the layered min-sum f32
    configurations the kernel serves, with the exact or the lazy syndrome.
    When a CUDA ``device`` is given, the kernel must serve the code there
    in one of its placements (:func:`placement`).

    Refused on purpose for now, though the TPU kernel serves them:
    sum-product, soft output and bf16 messages (ROADMAP Queue 2,
    kernel C).  The flooding schedule, and SCMS with it, is the TPU
    short-code kernel's, as here (ops/cuda_bp.py)."""
    if not isinstance(code, QCCode) or code.z < MIN_Z:
        return False
    if cfg is not None and not (
            cfg.schedule == "layered" and cfg.algorithm == "min-sum"
            and cfg.msg_dtype == "float32" and not cfg.soft_output
            and cfg.crc is None and cfg.outer is None):
        return False
    return device is None or placement(code, cuda_index(device)) > 0


def decode_qc_long_plain(code: QCCode, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch layered decode (ops/bp.py),
    whose JAX counterpart the reference pins bit-exact to the TPU kernel
    (tests/test_zlane.py); with ``syndrome_mode="lazy"`` its lazy loop,
    where a frame latches only on a sweep whose on-the-fly parity check
    passed.  The placement does not change the function."""
    return _decode_layered(code, cfg, llr, lazy=cfg.syndrome_mode == "lazy")


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
                   _force_global: bool = False) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the long-code
    kernel, one thread block per codeword, the posterior where the fit
    query places it (``_force_global`` puts it in global memory even where
    shared memory would hold it; for tests and probes).  Returns the same
    DecodeResult as ops/bp.py; ``total_iters`` is the largest sweep count
    of any codeword's block, which equals the batch's loop count of the
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
    place = GLOBAL if _force_global else placement(code, cuda_index(llr.device))
    batch = llr.shape[0]
    dev = llr.device
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=dev)
    conv = torch.empty((batch,), dtype=torch.bool, device=dev)
    iters = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return DecodeResult(bits, conv, iters,
                            torch.zeros((), dtype=torch.int32, device=dev))
    executed = torch.empty((batch,), dtype=torch.int32, device=dev)
    # the messages R [batch, num_blocks, z] and, in the global placement,
    # the posterior P [batch, n]: written by the kernel before it reads
    # them, so left uninitialised
    r_scratch = torch.empty((batch, code.num_blocks, code.z),
                            dtype=torch.float32, device=dev)
    p_scratch = (torch.empty((batch, code.n), dtype=torch.float32, device=dev)
                 if place == GLOBAL else None)
    tables, multi_edge = _device_tables(code, cfg.normalization, cfg.offset, dev)
    col, shift, ptr, flags, live_rows, alpha, beta = tables
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_bp_long(
            llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), r_scratch.data_ptr(),
            None if p_scratch is None else p_scratch.data_ptr(),
            col.data_ptr(), shift.data_ptr(), ptr.data_ptr(), flags.data_ptr(),
            live_rows.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            batch, code.n_b, code.z, code.m_b, code.num_blocks, _n_masks(code),
            int(multi_edge), code.max_row_degree, cfg.max_iters,
            int(cfg.early_exit), int(cfg.syndrome_mode == "lazy"), place, stream,
        )
    if err != 0:
        raise RuntimeError(f"bp_long kernel launch failed: CUDA error {err}")
    if place == GLOBAL:
        decode_qc_long.global_launches += 1
    else:
        decode_qc_long.launches += 1
    return DecodeResult(bits, conv, iters, executed.max())


decode_qc_long.launches = 0
decode_qc_long.global_launches = 0
