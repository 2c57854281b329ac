"""myldpccppapi_torch: the PyTorch / CUDA port of myldpccppapi_tpu.

A quasi-cyclic LDPC channel-coding framework for one NVIDIA GPU: 802.16e and
802.11n QC parity-check construction, regular array codes and the
802.3an-class RS-based codes, systematic
Richardson-Urbanke and information-set encoding, CRC and DVB-S2 outer-BCH
attach/check,
5G NR-style BG1/BG2 codes with triangular encoding and rate matching,
DVB-S2 IRA codes in z=360 QC form with accumulator encoding and bit
interleaving, BPSK/AWGN and QAM/PSK/APSK channel simulation with max-log
or exact soft demapping and BICM-ID, batched layered and flooding belief
propagation
(normalized/offset min-sum, sum-product, self-corrected min-sum, soft
output; f32 or bf16 messages) with per-codeword syndrome early termination
(exact or lazy), CRC / outer-BCH-aided acceptance and two-phase straggler
triage, and resumable BER/FER waterfall campaigns.
The decode runs in hand-written CUDA kernels on a CUDA device
(``csrc/bp_layered.cu`` for short codes, RS-LDPC and small-z 5G NR,
``csrc/bp_long.cu`` for long ones) and as plain torch ops on the CPU.  Entry points run on the card unless given ``device="cpu"``.

The JAX package ``myldpccppapi_tpu`` is the reference this port is held
against; this package never imports it or JAX.
"""
from .codes import (
    Encoder,
    QCCode,
    RSLDPCCode,
    bit_deinterleave,
    bit_interleave,
    dvbs2,
    dvbs2_ira_qc,
    ira_encode_fn,
    ira_encode_numpy,
    nr_code,
    regular,
    rs_ldpc,
    std_interleave,
    wifi,
    wimax,
)
from .decoder import DecodeResult, Decoder
from .utils.config import DecoderConfig
from .coder import Coder, make_codec
from .ops.modulation import (
    MODULATIONS,
    Modulation,
    demap_llr,
    make_modulation,
    modulate,
)
from .ops.bicm_id import bicm_id_receive, make_bicm_id_receive

__version__ = "0.1.0"

__all__ = [
    "Coder",
    "Decoder",
    "DecodeResult",
    "DecoderConfig",
    "Encoder",
    "MODULATIONS",
    "Modulation",
    "QCCode",
    "RSLDPCCode",
    "bicm_id_receive",
    "bit_deinterleave",
    "bit_interleave",
    "demap_llr",
    "dvbs2",
    "dvbs2_ira_qc",
    "ira_encode_fn",
    "ira_encode_numpy",
    "make_bicm_id_receive",
    "make_codec",
    "make_modulation",
    "modulate",
    "nr_code",
    "regular",
    "rs_ldpc",
    "std_interleave",
    "wifi",
    "wimax",
    "__version__",
]
