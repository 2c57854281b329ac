"""Regular (j, k) quasi-cyclic LDPC codes (array / Fossorier construction).

Counterpart of ``myldpccppapi_tpu/codes/regular.py``: the BASELINE config-1
family, a small regular (3,6) rate-1/2 code, n=648.  Base matrix ``s[i][j]
= (i * j) mod z`` of shifted z x z identities, the classic array-LDPC
protograph.

Any fully regular QC code's square parity block is singular over GF(2), so
H is rank-deficient by construction.  The code therefore carries an
explicit information set (``QCCode.info_cols``) from the GF(2) row
reduction, and encoding uses the information-set encoder
(:func:`myldpccppapi_torch.codes.encoder.generic_precompute`).  The
decoders run on H as it is (redundant checks are harmless).
"""
from __future__ import annotations

import numpy as np

from .gf2 import gf2_rref
from .qc import QCCode

__all__ = ["regular", "array_code_base"]


def array_code_base(row_wt: int, col_wt: int, z: int) -> np.ndarray:
    """[col_wt, row_wt] base matrix with shifts (i*j) mod z."""
    return np.asarray(
        [[(i * j) % z for j in range(row_wt)] for i in range(col_wt)],
        dtype=np.int32,
    )


def regular(n: int = 648, row_wt: int = 6, col_wt: int = 3) -> QCCode:
    """Regular (col_wt, row_wt) QC-LDPC code of length ``n``: z = n /
    row_wt; for (3,6) n=648 the dimension is 328 (rate 0.5062, four
    redundant checks)."""
    if n % row_wt:
        raise ValueError(f"n={n} must be a multiple of row weight {row_wt}")
    z = n // row_wt
    base = array_code_base(row_wt, col_wt, z)
    probe = QCCode(name="probe", base=base, z=z)
    _, pivot_cols = gf2_rref(probe.h_dense())
    info_cols = np.setdiff1d(np.arange(n, dtype=np.int64), pivot_cols)
    return QCCode(
        name=f"regular_{col_wt}_{row_wt}_n{n}",
        base=base,
        z=z,
        info_cols=info_cols,
    )
