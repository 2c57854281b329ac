"""Code construction: base matrices, QC lifting, GF(2) algebra, encoders."""
from .qc import QCCode
from .encoder import Encoder, EncoderMatrices, encode_numpy, ru_precompute
from .wimax import wimax

__all__ = [
    "QCCode",
    "Encoder",
    "EncoderMatrices",
    "encode_numpy",
    "ru_precompute",
    "wimax",
]
