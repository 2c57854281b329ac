"""Code construction: base matrices, QC lifting, RS-LDPC, the DVB-S2
standard-domain oracle, GF(2) algebra, encoders, and the TS 38.212
transport-block chain."""
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
    DVBS2Code,
    bit_deinterleave,
    bit_interleave,
    dvbs2,
    dvbs2_ira_qc,
    dvbs2_oracle,
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
from .nr_transport import (
    NRTransport,
    TBFormat,
    TBResult,
    deinterleave_llr,
    interleave_bits,
    plan_tb,
    select_base_graph,
)
from .regular import regular
from .rs_ldpc import RSLDPCCode, rs_ldpc, rs_ldpc_from_n
from .wifi import wifi
from .wimax import wimax

__all__ = [
    "BIT_INTERLEAVER_COLS",
    "DVBS2Code",
    "NRTransport",
    "QCCode",
    "RSLDPCCode",
    "bit_deinterleave",
    "bit_interleave",
    "dvbs2",
    "dvbs2_ira_qc",
    "dvbs2_oracle",
    "deinterleave_llr",
    "Encoder",
    "EncoderMatrices",
    "encode_numpy",
    "generic_precompute",
    "harq_combine",
    "interleave_bits",
    "ira_encode_fn",
    "ira_encode_numpy",
    "nr_base_graph",
    "nr_code",
    "plan_tb",
    "rate_match_bits",
    "rate_match_llr",
    "regular",
    "ru_precompute",
    "rs_ldpc",
    "rs_ldpc_from_n",
    "rv_start",
    "select_base_graph",
    "std_interleave",
    "TBFormat",
    "TBResult",
    "triangular_encode_fn",
    "triangular_encode_numpy",
    "wifi",
    "wimax",
]
