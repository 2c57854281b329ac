"""Wrapper of the hand-written layered BP kernel (``csrc/bp_layered.cu``).

Counterpart of ``myldpccppapi_tpu/ops/pallas_bp.py`` in its layered min-sum
f32 mode.  :func:`decode_qc_cuda` launches the kernel for a CUDA tensor and
raises if it cannot; for a CPU tensor it runs the plain version,
:func:`decode_qc_cuda_plain` (the torch path of ops/bp.py).  There is no
fallback from a failed build or launch.  ``decode_qc_cuda.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from . import _build
from .bp import DecodeResult, decode_layered, layer_weights

__all__ = ["REQUIREMENTS", "decode_qc_cuda", "decode_qc_cuda_plain",
           "supported", "tile_size"]

#: same block-count gate as the TPU kernel's auto dispatch
#: (pallas_bp._DYN_BLOCK_THRESHOLD)
_MAX_BLOCKS = 120
#: what :func:`supported` asks of a code and a config, for error messages
REQUIREMENTS = (
    f"a cyclic, unmasked QCCode without extra blocks, at most {_MAX_BLOCKS} "
    "circulants, a codeword state that fits a thread block's shared memory, "
    "and layered min-sum f32"
)


def _device_index(device) -> int:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {device}")
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=64)
def tile_size(code: QCCode, device_index: int) -> int:
    """Codewords per thread block on CUDA device ``device_index``: the most
    whose state fits the block's shared memory, with z threads per codeword
    (0 if not even one fits).  The kernel library computes it from its own
    shared-memory layout and the device's limits, so it builds the kernel at
    first use."""
    tile = _build.load().ldpc_bp_layered_tile(
        code.n, code.z, code.m_b, code.num_blocks, device_index)
    if tile < 0:
        raise RuntimeError(f"bp_layered tile query failed: CUDA error {-tile}")
    return tile


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for an unmasked (circulant) QC code without multi-edge blocks,
    with at most 120 circulants, and — when ``cfg`` is given — for the
    layered min-sum f32 configurations the kernel serves.  When a CUDA
    ``device`` is given, its per-codeword state must also fit a thread
    block's shared memory there (:func:`tile_size`)."""
    if not isinstance(code, QCCode):
        return False
    if code.masked_rows or code.extra_blocks or code.num_blocks > _MAX_BLOCKS:
        return False
    if cfg is not None and not (
            cfg.schedule == "layered" and cfg.algorithm == "min-sum"
            and cfg.msg_dtype == "float32" and not cfg.soft_output
            and cfg.crc is None and cfg.outer is None):
        return False
    return device is None or tile_size(code, _device_index(device)) >= 1


def decode_qc_cuda_plain(code: QCCode, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch layered decode (ops/bp.py),
    whose JAX counterpart the reference pins bit-exact to the TPU kernel."""
    return decode_layered(code, cfg, llr)


@functools.lru_cache(maxsize=32)
def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """Code structure and per-layer weights as device arrays, cached per
    (code, weights, device) so a launch copies nothing from the host."""
    _, bc, sh = code.blocks
    alphas, betas = layer_weights(normalization, offset, code.m_b)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return (dev(bc, np.int32), dev(sh, np.int32), dev(code.layer_ptr, np.int32),
            dev(alphas, np.float32), dev(betas, np.float32))


def decode_qc_cuda(code: QCCode, cfg: DecoderConfig,
                   llr: torch.Tensor) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the layered
    kernel.  Returns the same DecodeResult as ops/bp.py; ``total_iters`` is
    the largest sweep count of any thread block, which equals the batch's
    loop count of the single-loop torch path."""
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
            f"the CUDA layered kernel does not serve {code.name} under this "
            f"config: it needs {REQUIREMENTS}"
        )
    return _launch(code, cfg, llr, tile_size(code, llr.device.index))


def _launch(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor,
            tile: int) -> DecodeResult:
    """Launch the kernel on a checked, contiguous CUDA ``llr`` with ``tile``
    codewords per thread block (any tile from 1 to :func:`tile_size` gives
    the same result)."""
    batch = llr.shape[0]
    dev = llr.device
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=dev)
    conv = torch.empty((batch,), dtype=torch.bool, device=dev)
    iters = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return DecodeResult(bits, conv, iters,
                            torch.zeros((), dtype=torch.int32, device=dev))
    executed = torch.empty(((batch + tile - 1) // tile,), dtype=torch.int32,
                           device=dev)
    col, shift, ptr, alpha, beta = _device_tables(
        code, cfg.normalization, cfg.offset, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_bp_layered(
            llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), col.data_ptr(), shift.data_ptr(),
            ptr.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            batch, code.n_b, code.z, code.m_b, code.num_blocks, tile,
            cfg.max_iters, int(cfg.early_exit), stream,
        )
    if err != 0:
        raise RuntimeError(f"bp_layered kernel launch failed: CUDA error {err}")
    decode_qc_cuda.launches += 1
    return DecodeResult(bits, conv, iters, executed.max())


decode_qc_cuda.launches = 0
