"""myldpccppapi_torch: the PyTorch / CUDA port of myldpccppapi_tpu.

A quasi-cyclic LDPC channel-coding framework for one NVIDIA GPU: 802.16e QC
parity-check construction, systematic Richardson-Urbanke encoding,
5G NR-style BG1/BG2 codes with triangular encoding and rate matching,
BPSK/AWGN channel simulation, batched layered normalized/offset min-sum
decoding with per-codeword syndrome early termination and two-phase
straggler triage, and resumable BER/FER waterfall campaigns.  The decode
runs in hand-written CUDA kernels on a CUDA device (``csrc/bp_layered.cu``
for short codes, ``csrc/bp_long.cu`` for long ones) and as plain torch ops
elsewhere.

The JAX package ``myldpccppapi_tpu`` is the reference this port is held
against; this package never imports it or JAX.
"""
from .codes import Encoder, QCCode, nr_code, wimax
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
    "nr_code",
    "wimax",
    "__version__",
]
