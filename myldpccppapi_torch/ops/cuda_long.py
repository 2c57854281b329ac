"""Wrapper of the hand-written long-code layered BP kernel
(``csrc/bp_long.cu``).

Counterpart of ``myldpccppapi_tpu/ops/pallas_zlane.py`` (``decode_qc_zlane``)
in its layered min-sum f32 mode with the exact syndrome, on single-circulant
QC codes: the 5G NR path.  :func:`decode_qc_long` launches the kernel for a
CUDA tensor and raises if it cannot; for a CPU tensor it runs the plain
version, :func:`decode_qc_long_plain` (the torch path of ops/bp.py).  There
is no fallback from a failed build or launch.  ``decode_qc_long.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from . import _build
from .bp import DecodeResult, decode_layered
from .cuda_bp import _device_index, _device_tables

__all__ = ["REQUIREMENTS", "decode_qc_long", "decode_qc_long_plain", "fits",
           "supported"]

#: the reference kernel's gate (pallas_zlane.zlane_supported): below half a
#: 128-lane tile the TPU layout wastes the VPU, and small-z codes go to the
#: short-code kernels there
_MIN_Z = 64
#: what :func:`supported` asks of a code and a config, for error messages;
#: the kernel's own bounds stay in csrc/bp_long.cu, behind its fit query
REQUIREMENTS = (
    "a single-circulant QCCode (no extra blocks, no masked rows) with "
    f"z >= {_MIN_Z} that the kernel library's fit query accepts (z threads "
    "per block and the widest row within the kernel's bounds, the posterior "
    "within a thread block's shared memory), and layered min-sum f32 with "
    "the exact syndrome"
)


@functools.lru_cache(maxsize=64)
def fits(code: QCCode, device_index: int) -> bool:
    """Whether the kernel serves ``code`` on CUDA device ``device_index``:
    z threads per block within the kernel's bound, the widest row within
    its register budget, and the posterior within a block's shared memory.
    The kernel library answers from its own layout and the device's limits,
    so this builds the kernel at first use."""
    ok = _build.load().ldpc_bp_long_fits(
        code.n, code.z, code.m_b, code.num_blocks, code.max_row_degree,
        device_index)
    if ok < 0:
        raise RuntimeError(f"bp_long fit query failed: CUDA error {-ok}")
    return ok == 1


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for a single-circulant QC code (no multi-edge blocks, no masked
    rows) with z >= 64 and, when ``cfg`` is given, for the layered min-sum
    f32 exact-syndrome configurations the kernel serves.  When a CUDA
    ``device`` is given, the code must also fit there (:func:`fits`).

    Refused on purpose for now, though the TPU kernel serves them: codes
    with multi-edge blocks or masked rows (DVB-S2), and sum-product,
    soft output, bf16 messages and the lazy syndrome (ROADMAP Queue 2,
    kernel C)."""
    if not isinstance(code, QCCode):
        return False
    if code.masked_rows or code.extra_blocks or code.z < _MIN_Z:
        return False
    if cfg is not None and not (
            cfg.schedule == "layered" and cfg.algorithm == "min-sum"
            and cfg.msg_dtype == "float32" and not cfg.soft_output
            and cfg.syndrome_mode == "exact"
            and cfg.crc is None and cfg.outer is None):
        return False
    return device is None or fits(code, _device_index(device))


def decode_qc_long_plain(code: QCCode, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch layered decode (ops/bp.py),
    whose JAX counterpart the reference pins bit-exact to the TPU kernel
    (tests/test_zlane.py)."""
    return decode_layered(code, cfg, llr)


def decode_qc_long(code: QCCode, cfg: DecoderConfig,
                   llr: torch.Tensor) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the long-code
    kernel, one thread block per codeword.  Returns the same DecodeResult
    as ops/bp.py; ``total_iters`` is the largest sweep count of any
    codeword's block, which equals the batch's loop count of the
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
    batch = llr.shape[0]
    dev = llr.device
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=dev)
    conv = torch.empty((batch,), dtype=torch.bool, device=dev)
    iters = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return DecodeResult(bits, conv, iters,
                            torch.zeros((), dtype=torch.int32, device=dev))
    executed = torch.empty((batch,), dtype=torch.int32, device=dev)
    # the messages R, [batch, num_blocks, z]: read only after the kernel
    # has written them, so left uninitialised
    r_scratch = torch.empty((batch, code.num_blocks, code.z),
                            dtype=torch.float32, device=dev)
    col, shift, ptr, alpha, beta = _device_tables(
        code, cfg.normalization, cfg.offset, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldpc_bp_long(
            llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), r_scratch.data_ptr(), col.data_ptr(),
            shift.data_ptr(), ptr.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), batch, code.n_b, code.z, code.m_b,
            code.num_blocks, cfg.max_iters, int(cfg.early_exit), stream,
        )
    if err != 0:
        raise RuntimeError(f"bp_long kernel launch failed: CUDA error {err}")
    decode_qc_long.launches += 1
    return DecodeResult(bits, conv, iters, executed.max())


decode_qc_long.launches = 0
