"""Code construction: base matrices, QC lifting, RS-LDPC, GF(2) algebra,
encoders."""
from .qc import QCCode
from .encoder import (
    Encoder,
    EncoderMatrices,
    encode_numpy,
    generic_precompute,
    ru_precompute,
)
from .dvbs2 import (
    BIT_INTERLEAVER_COLS,
    bit_deinterleave,
    bit_interleave,
    dvbs2,
    dvbs2_ira_qc,
    ira_encode_fn,
    ira_encode_numpy,
    std_interleave,
)
from .nr import (
    harq_combine,
    nr_base_graph,
    nr_code,
    rate_match_bits,
    rate_match_llr,
    rv_start,
    triangular_encode_fn,
    triangular_encode_numpy,
)
from .regular import regular
from .rs_ldpc import RSLDPCCode, rs_ldpc, rs_ldpc_from_n
from .wifi import wifi
from .wimax import wimax

__all__ = [
    "BIT_INTERLEAVER_COLS",
    "QCCode",
    "RSLDPCCode",
    "bit_deinterleave",
    "bit_interleave",
    "dvbs2",
    "dvbs2_ira_qc",
    "Encoder",
    "EncoderMatrices",
    "encode_numpy",
    "generic_precompute",
    "harq_combine",
    "ira_encode_fn",
    "ira_encode_numpy",
    "nr_base_graph",
    "nr_code",
    "rate_match_bits",
    "rate_match_llr",
    "regular",
    "ru_precompute",
    "rs_ldpc",
    "rs_ldpc_from_n",
    "rv_start",
    "std_interleave",
    "triangular_encode_fn",
    "triangular_encode_numpy",
    "wifi",
    "wimax",
]
