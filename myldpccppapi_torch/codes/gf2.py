"""Dense GF(2) linear algebra on NumPy bool arrays.

Counterpart of ``myldpccppapi_tpu/codes/gf2.py`` (the functions the RU and
the information-set encoder precomputes need).  Used only for one-time
encoder precompute on the host; the batched encode runs as a float32
matmul mod 2 (:mod:`myldpccppapi_torch.codes.encoder`).

Large problems go to the bit-packed C++ kernels of :mod:`..native`, at
the reference's thresholds: :func:`gf2_matmul` when ``a.size *
b.shape[1] > 2**22``, :func:`gf2_inv` when ``n >= 256``, :func:`gf2_rref`
(and so :func:`gf2_rank`) when the smaller side is ``>= 256``.  The NumPy
bodies (``matmul_plain``, ``inv_plain``, ``rref_plain``) serve the smaller
ones and are the plain versions the tests hold the library against; the
results are the same either way (the RREF is unique).  The library builds
at the first large call and raises if it cannot.
"""
from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["gf2_matmul", "gf2_inv", "gf2_solve", "gf2_rank", "gf2_rref",
           "matmul_plain", "inv_plain", "rref_plain"]

#: sizes from which each function runs on the native library
NATIVE_MATMUL_WORK = 1 << 22
NATIVE_MIN_SIDE = 256


def _as_bool(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.bool_:
        a = (a % 2).astype(np.bool_)
    return a


def matmul_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """:func:`gf2_matmul` in NumPy.  The product runs in float32 (BLAS):
    every partial sum is an integer no larger than the inner dimension,
    exact for inner dims below 2**24."""
    a = _as_bool(a)
    b = _as_bool(b)
    if a.shape[-1] >= 1 << 24:
        raise ValueError("inner dimension too large for an exact f32 product")
    return (a.astype(np.float32) @ b.astype(np.float32)) % 2 == 1


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2 for dense 0/1 matrices, returned as bool."""
    a = _as_bool(a)
    b = _as_bool(b)
    if a.ndim == 2 and b.ndim == 2 and a.size * b.shape[1] > NATIVE_MATMUL_WORK:
        return native.matmul_packed(a, b)
    return matmul_plain(a, b)


def inv_plain(m: np.ndarray) -> np.ndarray:
    """:func:`gf2_inv` in NumPy: Gauss-Jordan elimination with row
    pivoting."""
    m = _as_bool(m).copy()
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"expected square matrix, got {m.shape}")
    inv = np.eye(n, dtype=np.bool_)
    for col in range(n):
        pivots = np.nonzero(m[col:, col])[0]
        if pivots.size == 0:
            raise np.linalg.LinAlgError(f"matrix is singular over GF(2) at column {col}")
        p = col + pivots[0]
        if p != col:
            m[[col, p]] = m[[p, col]]
            inv[[col, p]] = inv[[p, col]]
        # eliminate this column from every other row (vectorized row XOR)
        rows = m[:, col].copy()
        rows[col] = False
        m[rows] ^= m[col]
        inv[rows] ^= inv[col]
    return inv


def gf2_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2).

    Raises ``np.linalg.LinAlgError`` if singular.
    """
    m = _as_bool(m)
    if m.ndim == 2 and m.shape[0] == m.shape[1] and m.shape[0] >= NATIVE_MIN_SIDE:
        return native.inv_packed(m)
    return inv_plain(m)


def gf2_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(2) for square invertible ``a``."""
    return gf2_matmul(gf2_inv(a), b)


def rref_plain(m: np.ndarray):
    """:func:`gf2_rref` in NumPy."""
    m = _as_bool(m).copy()
    rows, cols = m.shape
    rank = 0
    pivot_cols = []
    for col in range(cols):
        pivots = np.nonzero(m[rank:, col])[0]
        if pivots.size == 0:
            continue
        p = rank + pivots[0]
        if p != rank:
            m[[rank, p]] = m[[p, rank]]
        sel = m[:, col].copy()
        sel[rank] = False
        m[sel] ^= m[rank]
        pivot_cols.append(col)
        rank += 1
        if rank == rows:
            break
    return m[:rank], np.asarray(pivot_cols, dtype=np.int64)


def gf2_rref(m: np.ndarray):
    """Reduced row-echelon form over GF(2).

    Returns ``(rref, pivot_cols)`` where ``rref`` is [rank, cols] bool (zero
    rows dropped) and ``pivot_cols`` the pivot column index per row.  Pivot
    columns become parity positions of an information-set encoder, free
    columns carry information, and the row space (the code) is unchanged.
    The RREF is unique, so its pivots are the reference's whichever
    elimination computes them.
    """
    m = _as_bool(m)
    if min(m.shape) >= NATIVE_MIN_SIDE:
        return native.rref_packed(m)
    return rref_plain(m)


def gf2_rank(m: np.ndarray) -> int:
    """Rank of a dense 0/1 matrix over GF(2)."""
    return len(gf2_rref(m)[1])
