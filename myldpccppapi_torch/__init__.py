"""myldpccppapi_torch: the PyTorch / CUDA port of myldpccppapi_tpu.

A quasi-cyclic LDPC channel-coding framework for one NVIDIA GPU: 802.16e QC
parity-check construction, systematic Richardson-Urbanke encoding,
BPSK/AWGN channel simulation, and batched layered normalized/offset
min-sum decoding with per-codeword syndrome early termination and
two-phase straggler triage.  The decode runs in a hand-written CUDA kernel
(``csrc/bp_layered.cu``) on a CUDA device and as plain torch ops elsewhere.

The JAX package ``myldpccppapi_tpu`` is the reference this port is held
against; this package never imports it or JAX.
"""
from .codes import Encoder, QCCode, wimax
from .decoder import DecodeResult, Decoder
from .utils.config import DecoderConfig
from .coder import Coder

__version__ = "0.1.0"

__all__ = [
    "Coder",
    "Decoder",
    "DecodeResult",
    "DecoderConfig",
    "Encoder",
    "QCCode",
    "wimax",
    "__version__",
]
