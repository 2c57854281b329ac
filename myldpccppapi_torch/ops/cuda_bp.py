"""Wrapper of the hand-written short-code BP kernel (``csrc/bp_layered.cu``).

Counterpart of two TPU kernels of ``myldpccppapi_tpu/ops/pallas_bp.py``,
served as modes and routes of one CUDA kernel:

* ``_build_kernel`` (kernel A) in its f32 and bf16 modes: layered or
  flooding, min-sum (scalar or per-layer alpha/beta) or sum-product, SCMS
  on the flooding min-sum sweep, soft output (the latched posterior) on
  either schedule;
* ``_build_kernel_dyn`` (kernel B), the table-driven layered min-sum for
  base graphs of more than 120 circulants: the same kernel, which reads the
  code's structure from runtime tables anyway, gated to B's own domain
  (layered min-sum, scalar alpha/beta, no soft output; bf16 too, as A's
  bf16 sweep is the same sweep) and to codes kernel C does not serve
  (z < 64, the small-z 5G NR codes).

Under bf16 the wrapper casts the LLRs to bf16 on the card and the kernel
keeps its state in bf16, rounding after every operation as kernel A and
the jnp path do; its plain version is the torch path's bf16 decode
(ops/bp.py), which rounds at the same points.

:func:`decode_qc_cuda` launches the kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs the plain version,
:func:`decode_qc_cuda_plain` (the torch path of ops/bp.py).  There is no
fallback from a failed build or launch.  ``decode_qc_cuda.launches``
counts kernel launches in every mode, ``decode_qc_cuda.soft_launches``
those with soft output and ``decode_qc_cuda.bf16_launches`` those with
bf16 messages.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from ..utils.device import cuda_index
from . import _build
from .bp import DecodeResult, decode_qc, layer_weights, msg_dtype
from .cuda_long import MIN_Z as _LONG_MIN_Z

__all__ = ["REQUIREMENTS", "decode_qc_cuda", "decode_qc_cuda_plain",
           "mode", "supported", "tile_size"]

#: the TPU kernels' split (pallas_bp._DYN_BLOCK_THRESHOLD): up to this many
#: circulants kernel A's statically unrolled body, above it kernel B's
#: table-driven one
_MAX_BLOCKS = 120
#: mode bits, as csrc/bp_layered.cu reads them
FLOODING, SUM_PRODUCT, SCMS = 1, 2, 4
#: what :func:`supported` asks of a code and a config, for error messages
REQUIREMENTS = (
    "a cyclic, unmasked QCCode without extra blocks, whose codeword state "
    "(posterior and messages, f32 or bf16; the channel too for flooding, "
    "the sent messages too for SCMS) fits a thread block's shared memory; "
    f"at most {_MAX_BLOCKS} circulants under any schedule and algorithm, "
    f"with soft output or not, or more circulants with z < {_LONG_MIN_Z} "
    "under layered min-sum with scalar alpha/beta and no soft output "
    "(kernel B's domain); CRC or outer-code acceptance wraps it (Decoder)"
)


def mode(cfg: DecoderConfig) -> int:
    """The kernel's mode bits for ``cfg``: FLOODING, SUM_PRODUCT, SCMS."""
    return ((FLOODING if cfg.schedule == "flooding" else 0)
            | (SUM_PRODUCT if cfg.algorithm == "sum-product" else 0)
            | (SCMS if cfg.self_correction else 0))


@functools.lru_cache(maxsize=64)
def tile_size(code: QCCode, device_index: int, mode_bits: int = 0,
              itemsize: int = 4) -> int:
    """Codewords per thread block on CUDA device ``device_index`` in mode
    ``mode_bits`` (:func:`mode`; 0 = layered min-sum) with ``itemsize``-byte
    messages (4 f32, 2 bf16): the most whose state fits the block's shared
    memory, with z threads per codeword (0 if not even one fits).  The
    kernel library computes it from its own shared-memory layout and the
    device's limits, so it builds the kernel at first use."""
    tile = _build.load().ldpc_bp_layered_tile(
        code.n, code.z, code.m_b, code.num_blocks, mode_bits, itemsize,
        device_index)
    if tile < 0:
        raise RuntimeError(f"bp_layered tile query failed: CUDA error {-tile}")
    return tile


def _route_b(code: QCCode, cfg: DecoderConfig | None) -> bool:
    """Kernel B's domain (``pallas_bp._build_kernel_dyn`` refuses the rest,
    ``pallas_bp.py:424-430,534-538``), on the codes kernel C leaves (z below
    ``cuda_long.MIN_Z``), so auto dispatch keeps every code kernel C serves
    on it."""
    if code.z >= _LONG_MIN_Z:
        return False
    return cfg is None or (
        cfg.schedule == "layered" and cfg.algorithm == "min-sum"
        and not cfg.soft_output
        and isinstance(cfg.normalization, (int, float))
        and isinstance(cfg.offset, (int, float)))


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for an unmasked (circulant) QC code without multi-edge blocks
    and, when ``cfg`` is given, for the configurations the kernel serves,
    f32 or bf16 messages: with at most 120 circulants every schedule,
    algorithm and soft output (kernel A), with more only kernel B's layered
    min-sum on a code with z < 64.  A config with CRC or outer-code
    acceptance is refused (the kernel is syndrome-only; ``Decoder`` wraps
    it).  When a CUDA ``device`` is given, the per-codeword state of the
    config's mode must also fit a thread block's shared memory there
    (:func:`tile_size`)."""
    if not isinstance(code, QCCode):
        return False
    if code.masked_rows or code.extra_blocks:
        return False
    if code.num_blocks > _MAX_BLOCKS and not _route_b(code, cfg):
        return False
    if cfg is not None and not (cfg.crc is None and cfg.outer is None):
        return False
    mode_bits = 0 if cfg is None else mode(cfg)
    return device is None or tile_size(code, cuda_index(device), mode_bits,
                                       msg_dtype(cfg).itemsize) >= 1


def decode_qc_cuda_plain(code: QCCode, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch decode of ops/bp.py (layered or
    flooding), whose JAX counterpart the reference pins bit-exact to the TPU
    kernels in f32 (sum-product to a tolerance); under bf16 it rounds after
    every operation, as the kernel does."""
    return decode_qc(code, cfg, llr)


def _column_edges(code: QCCode) -> tuple[np.ndarray, np.ndarray]:
    """Per-column edge lists (CSC order): col_ptr [n_b + 1] and col_edge
    [num_blocks], the edges of block column j ascending at col_edge[col_ptr
    [j]:col_ptr[j + 1]], the order in which the flooding rebuild adds R."""
    _, bc, _ = code.blocks
    col_edge = np.argsort(bc, kind="stable")
    col_ptr = np.searchsorted(bc[col_edge], np.arange(code.n_b + 1))
    return col_ptr, col_edge


@functools.lru_cache(maxsize=32)
def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """Code structure, per-column edge lists and per-layer weights as device
    arrays, cached per (code, weights, device) so a launch copies nothing
    from the host."""
    _, bc, sh = code.blocks
    alphas, betas = layer_weights(normalization, offset, code.m_b)
    col_ptr, col_edge = _column_edges(code)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return (dev(bc, np.int32), dev(sh, np.int32), dev(code.layer_ptr, np.int32),
            dev(col_ptr, np.int32), dev(col_edge, np.int32),
            dev(alphas, np.float32), dev(betas, np.float32))


def decode_qc_cuda(code: QCCode, cfg: DecoderConfig,
                   llr: torch.Tensor) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the kernel in
    ``cfg``'s mode.  Returns the same DecodeResult as ops/bp.py, posteriors
    included (in the message dtype) with ``cfg.soft_output``; ``total_iters`` is the largest sweep
    count of any thread block, which equals the batch's loop count of the
    single-loop torch path."""
    if llr.ndim != 2 or llr.shape[1] != code.n:
        raise ValueError(f"expected llr of shape [batch, {code.n}], got "
                         f"{tuple(llr.shape)}")
    if llr.dtype != torch.float32:
        raise ValueError(f"expected float32 llr, got {llr.dtype}")
    if llr.device.type == "cpu":
        return decode_qc_cuda_plain(code, cfg, llr)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if not supported(code, cfg, llr.device):
        raise ValueError(
            f"the CUDA short-code kernel does not serve {code.name} under "
            f"this config: it needs {REQUIREMENTS}"
        )
    tile = tile_size(code, llr.device.index, mode(cfg), msg_dtype(cfg).itemsize)
    return _launch(code, cfg, llr, tile)


def _launch(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor,
            tile: int) -> DecodeResult:
    """Launch the kernel on a checked, contiguous CUDA ``llr`` with ``tile``
    codewords per thread block (any tile from 1 to :func:`tile_size` gives
    the same result)."""
    batch = llr.shape[0]
    dev = llr.device
    dt = msg_dtype(cfg)
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
    executed = torch.empty(((batch + tile - 1) // tile,), dtype=torch.int32,
                           device=dev)
    col, shift, ptr, col_ptr, col_edge, alpha, beta = _device_tables(
        code, cfg.normalization, cfg.offset, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_bp_layered(
            llr_k.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), None if post is None else post.data_ptr(),
            col.data_ptr(), shift.data_ptr(), ptr.data_ptr(),
            col_ptr.data_ptr(), col_edge.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), batch, code.n_b, code.z, code.m_b,
            code.num_blocks, tile, cfg.max_iters, int(cfg.early_exit),
            mode(cfg), int(dt == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"bp_layered kernel launch failed: CUDA error {err}")
    decode_qc_cuda.launches += 1
    decode_qc_cuda.soft_launches += post is not None
    decode_qc_cuda.bf16_launches += dt == torch.bfloat16
    return DecodeResult(bits, conv, iters, executed.max(), posteriors=post)


decode_qc_cuda.launches = 0
decode_qc_cuda.soft_launches = 0
decode_qc_cuda.bf16_launches = 0
