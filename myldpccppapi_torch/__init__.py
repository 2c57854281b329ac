"""myldpccppapi_torch: the PyTorch / CUDA port of myldpccppapi_tpu.

A quasi-cyclic LDPC channel-coding framework for one NVIDIA GPU: 802.16e QC
parity-check construction, systematic Richardson-Urbanke encoding,
5G NR-style BG1/BG2 codes with triangular encoding and rate matching,
DVB-S2 IRA codes in z=360 QC form with accumulator encoding, BPSK/AWGN
channel simulation, batched layered and flooding belief propagation
(normalized/offset min-sum, sum-product, self-corrected min-sum, soft
output) with per-codeword syndrome early termination (exact or lazy) and
two-phase straggler triage, and resumable BER/FER waterfall campaigns.
The decode runs in hand-written CUDA kernels on a CUDA device
(``csrc/bp_layered.cu`` for short codes and small-z 5G NR,
``csrc/bp_long.cu`` for long ones) and as plain torch ops on the CPU.  Entry points run on the card unless given ``device="cpu"``.

The JAX package ``myldpccppapi_tpu`` is the reference this port is held
against; this package never imports it or JAX.
"""
from .codes import (
    Encoder,
    QCCode,
    dvbs2,
    dvbs2_ira_qc,
    ira_encode_fn,
    ira_encode_numpy,
    nr_code,
    std_interleave,
    wimax,
)
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
    "dvbs2",
    "dvbs2_ira_qc",
    "ira_encode_fn",
    "ira_encode_numpy",
    "nr_code",
    "std_interleave",
    "wimax",
    "__version__",
]
