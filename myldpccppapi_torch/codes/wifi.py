"""IEEE 802.11n QC-LDPC code construction (Annex R tables).

NumPy copy of ``myldpccppapi_tpu/codes/wifi.py``.  Unlike 802.16e, the
802.11n tables are given per (n, rate) with the shifts used directly (no
z-rescaling).
"""
from __future__ import annotations

from .base_matrices import WIFI_SEEDS
from .qc import QCCode

__all__ = ["wifi"]

_Z_BY_N = {648: 27, 1296: 54, 1944: 81}


def wifi(n: int = 1944, rate: str = "5/6") -> QCCode:
    if n not in _Z_BY_N:
        raise ValueError(f"802.11n code length must be one of {sorted(_Z_BY_N)}, got {n}")
    key = (str(n), rate)
    if key not in WIFI_SEEDS:
        have = sorted(k for k in WIFI_SEEDS)
        raise ValueError(f"no 802.11n table for n={n}, rate={rate}; have {have}")
    return QCCode(
        name=f"wifi_n{n}_r{rate.replace('/', '')}",
        base=WIFI_SEEDS[key],
        z=_Z_BY_N[n],
    )
