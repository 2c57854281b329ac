"""RS-based LDPC construction (the IEEE 802.3an 10GBASE-T family).

NumPy copy of ``myldpccppapi_tpu/codes/rs_ldpc.py``.  The (2048, 1723)
LDPC of IEEE 802.3an is a (6, 32)-regular code built from Reed-Solomon
codes with two information symbols (Djurdjevic, Xu, Abdel-Ghaffar, Lin
2003).  H is computed from GF(2^s) arithmetic, no table:

    H = [ P(b_i * x_j) ]  for i < gamma row classes, j < rho columns,

where b_i are distinct nonzero slopes, x_j distinct evaluation points, and
``P(c)`` is the q x q permutation of the ADDITIVE group of GF(q=2^s):
row a has its one in column a XOR c (field addition is XOR on the standard
basis).  A 4-cycle would need
``c_{i1,j1} + c_{i1,j2} + c_{i2,j2} + c_{i2,j1} = (b_i1+b_i2)(x_j1+x_j2)``
to vanish, impossible for distinct slopes and points in a field, so girth
>= 6 by construction.

With the default GF(64), gamma=6, rho=32 the parity-check matrix has rank
325, giving the standard's (n, k) = (2048, 1723).  The standard pins one
specific slope/point labeling; this construction is the same code family
and rate (the published labeling is drop-in data via the
``slopes``/``points`` arguments).

XOR-block permutations are not circulants: the code is a class of its own
(``group = "xor"``), not a :class:`~.qc.QCCode`, so no circulant-only path
accepts it by its type.  It exposes QCCode's block protocol, and the
torch path (ops/bp.py) and the short-code kernel (csrc/bp_layered.cu)
align its blocks by ``y[i] = x[i ^ c]``.  Encoding uses the
information-set encoder (rank-deficient H, ``generic_precompute``).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple

import numpy as np

__all__ = ["RSLDPCCode", "rs_ldpc", "rs_ldpc_from_n", "gf2m_tables"]

#: Default primitive polynomials (low-term coefficient mask including the
#: constant; the x^s term is implicit), indexed by s.
_PRIM = {4: 0b0011, 5: 0b00101, 6: 0b000011, 7: 0b0001001, 8: 0b00011101}


def gf2m_tables(s: int, prim: Optional[int] = None):
    """(exp, log) tables for GF(2^s): exp[i] = alpha^i (length 2(q-1)),
    log[v] = i for v != 0."""
    q = 1 << s
    if prim is None:
        prim = _PRIM[s]
    exp = np.zeros(2 * (q - 1), np.int64)
    log = np.zeros(q, np.int64)
    v = 1
    for i in range(q - 1):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & q:
            v ^= q | prim
    exp[q - 1:] = exp[: q - 1]
    return exp, log


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: a cache key
class RSLDPCCode:
    """An RS-based LDPC code: gamma x rho array of q x q XOR-permutations.

    Exposes the same block protocol as :class:`~.qc.QCCode` (``blocks`` /
    ``layer_ptr`` / ``z`` / ``m_b`` ...) with ``group = "xor"``: a block
    "shift" c aligns tiles by the ADDITIVE permutation ``y[i] = x[i ^ c]``
    instead of a cyclic roll, so the block-structured decoders (the torch
    path of ops/bp.py and the short-code CUDA kernel, csrc/bp_layered.cu)
    serve this family.
    """

    name: str
    s: int                      #: field power (q = 2^s)
    shifts: np.ndarray          #: [gamma, rho] additive shifts c_ij in GF(q)

    #: block alignment group (QCCode's circulants are "cyclic")
    group = "xor"

    @property
    def q(self) -> int:
        return 1 << self.s

    @property
    def gamma(self) -> int:
        return self.shifts.shape[0]

    @property
    def rho(self) -> int:
        return self.shifts.shape[1]

    @property
    def n(self) -> int:
        return self.rho * self.q

    @property
    def m(self) -> int:
        return self.gamma * self.q

    # -- QCCode-compatible block protocol -----------------------------------
    @property
    def z(self) -> int:
        return self.q

    @property
    def m_b(self) -> int:
        return self.gamma

    @property
    def n_b(self) -> int:
        return self.rho

    @cached_property
    def blocks(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(block_row, block_col, xor_shift) in row-major order."""
        br = np.repeat(np.arange(self.gamma, dtype=np.int32), self.rho)
        bc = np.tile(np.arange(self.rho, dtype=np.int32), self.gamma)
        return br, bc, self.shifts.reshape(-1).astype(np.int32)

    @cached_property
    def block_row_masks(self) -> Tuple[None, ...]:
        return tuple(None for _ in range(self.num_blocks))

    @property
    def num_blocks(self) -> int:
        return self.gamma * self.rho

    @property
    def num_edges(self) -> int:
        return self.num_blocks * self.q

    @cached_property
    def layer_ptr(self) -> np.ndarray:
        return (np.arange(self.gamma + 1) * self.rho).astype(np.int32)

    @property
    def max_row_degree(self) -> int:
        return self.rho

    def h_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Edge list (rows, cols) of H in row-major order."""
        q = self.q
        a = np.arange(q, dtype=np.int64)
        rows, cols = [], []
        for i in range(self.gamma):
            for j in range(self.rho):
                rows.append(i * q + a)
                cols.append(j * q + (a ^ int(self.shifts[i, j])))
        order = np.argsort(np.concatenate(rows), kind="stable")
        return (np.concatenate(rows)[order].astype(np.int64),
                np.concatenate(cols)[order].astype(np.int64))

    def h_dense(self) -> np.ndarray:
        h = np.zeros((self.m, self.n), np.bool_)
        r, c = self.h_coo()
        h[r, c] = True
        return h

    @cached_property
    def _mats(self):
        from .encoder import generic_precompute

        return generic_precompute(self.h_dense())

    @property
    def encoder_matrices(self):
        """Information-set encoder precompute (H is rank-deficient)."""
        return self._mats

    @property
    def k_info(self) -> int:
        """True dimension n - rank(H) (1723 for the 802.3an defaults)."""
        return self._mats.w.shape[1]

    @property
    def info_positions(self) -> np.ndarray:
        return self._mats.perm[: self.k_info]

    def syndrome(self, cw: np.ndarray) -> np.ndarray:
        r, c = self.h_coo()
        cw = np.asarray(cw, np.int64)
        syn = np.zeros(cw.shape[:-1] + (self.m,), np.int64)
        np.add.at(syn, (Ellipsis, r), cw[..., c])
        return syn % 2

    def describe(self) -> str:
        return (
            f"{self.name}: RS-LDPC GF({self.q}) ({self.gamma},{self.rho})-"
            f"regular n={self.n} k={self.k_info}"
        )


def rs_ldpc(s: int = 6, gamma: int = 6, rho: int = 32,
            prim: Optional[int] = None,
            slopes: Optional[np.ndarray] = None,
            points: Optional[np.ndarray] = None) -> RSLDPCCode:
    """Build an RS-based LDPC code; defaults give the 802.3an-class
    (2048, 1723) over GF(64).

    ``slopes``: gamma distinct nonzero field elements (default
    alpha^0..alpha^{gamma-1}); ``points``: rho distinct field elements
    (default 0, alpha^0..alpha^{rho-2}).  Pass the published labeling for
    bit interoperability with a specific standard matrix.
    """
    q = 1 << s
    if gamma >= q or rho > q:
        raise ValueError(f"need gamma < {q} nonzero slopes and rho <= {q} points")
    exp, _ = gf2m_tables(s, prim)
    if slopes is None:
        slopes = exp[:gamma]
    if points is None:
        points = np.concatenate([[0], exp[: rho - 1]])
    slopes = np.asarray(slopes, np.int64)
    points = np.asarray(points, np.int64)
    if len(np.unique(slopes)) != gamma or (slopes == 0).any():
        raise ValueError("slopes must be distinct and nonzero")
    if len(np.unique(points)) != rho:
        raise ValueError("points must be distinct")
    _, log = gf2m_tables(s, prim)
    shifts = np.zeros((gamma, rho), np.int64)
    for i, b in enumerate(slopes):
        for j, x in enumerate(points):
            shifts[i, j] = 0 if x == 0 else int(exp[log[b] + log[x]])
    return RSLDPCCode(name=f"rs_ldpc_gf{q}_{gamma}x{rho}", s=s, shifts=shifts)


def rs_ldpc_from_n(n: int) -> RSLDPCCode:
    """The default (6, 32)-regular code of blocklength ``n = 32 * 2^s``
    (n=2048 is the 802.3an-class (2048, 1723) code).  One shared
    validation for every n-keyed entry point (CLI, make_codec,
    benchmarks)."""
    q = n // 32
    s = q.bit_length() - 1
    if n != 32 * (1 << s):
        raise ValueError(f"rs_ldpc needs n = 32 * 2^s (e.g. 2048), got {n}")
    return rs_ldpc(s=s)
