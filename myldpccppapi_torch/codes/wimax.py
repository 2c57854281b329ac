"""IEEE 802.16e (WiMAX) QC-LDPC code construction.

NumPy copy of ``myldpccppapi_tpu/codes/wimax.py``.

Replicates the reference's construction rules (``Coder::initCheckMatrix``,
``MyLdpc.cpp:52-135``): the lifting size is ``z = n / 24`` and the seed-table
shift ``p`` scales as ``p * z // 96`` for every rate except 2/3A, which uses
``p % z`` — exactly the 802.16e standard rule.
"""
from __future__ import annotations

import numpy as np

from .base_matrices import WIMAX_N_B, wimax_seed
from .qc import QCCode

__all__ = ["wimax", "scale_seed"]


def scale_seed(seed: np.ndarray, z: int, rate: str) -> np.ndarray:
    """Scale an 802.16e seed table (given for z0=96) to lifting size ``z``."""
    seed = np.asarray(seed, dtype=np.int64)
    if rate == "2/3A":
        scaled = np.where(seed >= 0, seed % z, -1)
    else:
        scaled = np.where(seed >= 0, seed * z // 96, -1)
    return scaled.astype(np.int32)


def wimax(n: int = 576, rate: str = "3/4B") -> QCCode:
    """Construct an 802.16e code of length ``n`` (multiple of 24) and rate.

    Standard lengths are n = 576 .. 2304 in steps of 96 (z = 24..96), but any
    z = n/24 is accepted — the scaling rule generalizes.
    """
    if n % WIMAX_N_B != 0:
        raise ValueError(f"802.16e code length must be a multiple of {WIMAX_N_B}, got {n}")
    z = n // WIMAX_N_B
    seed = wimax_seed(rate)
    base = scale_seed(seed, z, rate)
    return QCCode(name=f"wimax_n{n}_r{rate.replace('/', '')}", base=base, z=z)
