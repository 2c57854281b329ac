"""Quasi-cyclic LDPC code objects.

NumPy copy of ``myldpccppapi_tpu/codes/qc.py``.  Instead of per-edge linked
adjacency the code keeps the *block* structure: every nonzero entry of the
base matrix is a cyclically shifted ``z x z`` identity, so every
Tanner-graph gather/scatter is a cyclic rotation of a contiguous ``[z,
batch]`` tile (torch path) or an index ``(r + shift) % z`` computed in the
CUDA kernel.

Layout conventions used throughout the decoders:

* LLR / posterior tensors are ``[n_b, z, B]`` (block-col, row-in-block, batch).
* Per-edge message tensors are ``[E_b, z, B]`` where ``E_b`` is the number of
  nonzero base-matrix blocks, in row-major (layer) order, **row-aligned**:
  element ``[e, r]`` is the message on the edge between check ``i_e*z + r``
  and variable ``j_e*z + (r + shift_e) % z``.
* ``row_aligned = roll(col_aligned, -shift)`` and
  ``col_aligned = roll(row_aligned, +shift)`` along the ``z`` axis.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np

__all__ = ["QCCode"]


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class QCCode:
    """A lifted quasi-cyclic LDPC code defined by a base matrix and ``z``.

    ``base`` entries are cyclic-shift exponents in ``[0, z)`` or ``-1`` for an
    all-zero block.  The code is systematic with the first ``k`` columns being
    information bits (matching the reference's 802.16e layout).
    """

    name: str
    base: np.ndarray  # [m_b, n_b] int32, already scaled to this z
    z: int
    #: Number of leading systematic bits that are never transmitted
    #: (5G NR punctures the first 2*Z columns).  0 for 802.16e/802.11n.
    punctured_front: int = 0
    #: Information-bit positions within the codeword, or None for the
    #: systematic default (first ``k = n - m`` columns).  Set by code
    #: families whose H is rank-deficient (e.g. fully regular (3,6) QC
    #: codes, where the parity block is provably singular over GF(2)) —
    #: the generic encoder then picks pivot columns as parity positions.
    info_cols: "np.ndarray | None" = None
    #: Additional circulants beyond ``base``: tuple of (block_row,
    #: block_col, shift).  A base position may then hold SEVERAL shifted
    #: identities (multi-edge blocks) — EN 302 307 DVB-S2 tables place two
    #: addresses of one bit group in the same row-residue class, which the
    #: reference's single-shift-per-block layout cannot represent.  The
    #: layered decoders handle this via delta-accumulate writeback.
    extra_blocks: "Tuple[Tuple[int, int, int], ...] | None" = None
    #: Partial circulants: ((block_row, block_col, shift), excluded check
    #: rows) entries.  Row r of that block contributes no edge.  Needed for
    #: the DVB-S2 accumulator's wrap block, whose first check row has no
    #: predecessor parity bit (the z x z circulant is one entry short).
    masked_rows: "Tuple[Tuple[Tuple[int, int, int], Tuple[int, ...]], ...] | None" = None

    def __post_init__(self):
        base = np.asarray(self.base, dtype=np.int32)
        object.__setattr__(self, "base", base)
        if base.ndim != 2:
            raise ValueError("base matrix must be 2-D")
        if np.any(base >= self.z):
            raise ValueError("shift exponent >= z; scale the seed first")
        if self.extra_blocks:
            for (i, j, s) in self.extra_blocks:
                if not (0 <= i < base.shape[0] and 0 <= j < base.shape[1]):
                    raise ValueError(f"extra block ({i},{j}) out of range")
                if not (0 <= s < self.z):
                    raise ValueError(f"extra block shift {s} out of [0, z)")
                if base[i, j] == s:
                    raise ValueError(
                        f"extra block ({i},{j},{s}) duplicates the base "
                        "entry; coincident circulants cancel over GF(2)"
                    )

    # -- sizes ------------------------------------------------------------
    @property
    def m_b(self) -> int:
        return self.base.shape[0]

    @property
    def n_b(self) -> int:
        return self.base.shape[1]

    @property
    def n(self) -> int:
        return self.n_b * self.z

    @property
    def m(self) -> int:
        return self.m_b * self.z

    @property
    def k(self) -> int:
        """Design dimension n - m (equals the true dimension when H has
        full rank; see :attr:`k_info` for the general case)."""
        return self.n - self.m

    @property
    def k_info(self) -> int:
        """True code dimension: n - rank(H)."""
        return len(self.info_cols) if self.info_cols is not None else self.k

    @property
    def info_positions(self) -> np.ndarray:
        """Codeword positions carrying information bits."""
        if self.info_cols is not None:
            return np.asarray(self.info_cols, dtype=np.int64)
        return np.arange(self.k, dtype=np.int64)

    @property
    def rate(self) -> float:
        return self.k_info / self.n

    # -- block structure ---------------------------------------------------
    @cached_property
    def blocks(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(block_row, block_col, shift) int32 arrays in row-major order.

        Includes :attr:`extra_blocks`; within one (row, col) position the
        base-matrix circulant comes first, extras follow in declaration
        order (a stable order all decoders share).
        """
        rows, cols = np.nonzero(self.base >= 0)
        shifts = self.base[rows, cols]
        if self.extra_blocks:
            er, ec, es = zip(*self.extra_blocks)
            rows = np.concatenate([rows, np.asarray(er)])
            cols = np.concatenate([cols, np.asarray(ec)])
            shifts = np.concatenate([shifts, np.asarray(es)])
            order = np.argsort(rows * self.n_b + cols, kind="stable")
            rows, cols, shifts = rows[order], cols[order], shifts[order]
        return (rows.astype(np.int32), cols.astype(np.int32),
                shifts.astype(np.int32))

    @cached_property
    def block_row_masks(self) -> Tuple["np.ndarray | None", ...]:
        """Per block (aligned with :attr:`blocks`): bool[z] of LIVE check
        rows, or None for a full circulant."""
        br, bc, sh = self.blocks
        if not self.masked_rows:
            return tuple(None for _ in range(len(br)))
        lookup = {}
        for (key, excluded) in self.masked_rows:
            mask = np.ones(self.z, dtype=bool)
            mask[list(excluded)] = False
            lookup[tuple(key)] = mask
        out = []
        for e in range(len(br)):
            out.append(lookup.get((int(br[e]), int(bc[e]), int(sh[e]))))
        return tuple(out)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks[0])

    @property
    def num_edges(self) -> int:
        """True Tanner-graph edge count (masked rows excluded)."""
        total = self.num_blocks * self.z
        if self.masked_rows:
            total -= sum(len(excl) for (_, excl) in self.masked_rows)
        return total

    @cached_property
    def layer_ptr(self) -> np.ndarray:
        """Prefix offsets into :attr:`blocks` per base row; shape [m_b+1]."""
        counts = np.bincount(self.blocks[0], minlength=self.m_b)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def layer(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(block_cols, shifts) of base row ``i`` (row-major block order)."""
        br, bc, sh = self.blocks
        sel = br == i
        return bc[sel], sh[sel]

    @cached_property
    def row_degrees(self) -> np.ndarray:
        """Block degree per base row (circulant count, incl. extras)."""
        return np.bincount(self.blocks[0], minlength=self.m_b)

    @property
    def col_degrees(self) -> np.ndarray:
        """Block degree per base column (circulant count, incl. extras)."""
        return np.bincount(self.blocks[1], minlength=self.n_b)

    @cached_property
    def max_row_degree(self) -> int:
        return int(self.row_degrees.max())

    @property
    def max_col_degree(self) -> int:
        return int(self.col_degrees.max())

    # -- expanded representations (host-side, for tests / encoder) ---------
    def h_dense(self) -> np.ndarray:
        """Full parity-check matrix as a [m, n] bool array.

        Expansion rule matches the reference (``MyLdpc.cpp:95-103``): block
        (i, j) with shift s has ones at (i*z + r, j*z + (r+s) % z).
        """
        h = np.zeros((self.m, self.n), dtype=np.bool_)
        z = self.z
        br, bc, sh = self.blocks
        masks = self.block_row_masks
        for e in range(len(br)):
            r = np.arange(z) if masks[e] is None else np.nonzero(masks[e])[0]
            # XOR so coincident entries of two circulants cancel over GF(2)
            h[br[e] * z + r, bc[e] * z + (r + sh[e]) % z] ^= True
        return h

    def h_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Edge list (rows, cols) in row-major order: by global check row,
        then ascending column — the same edge order as the reference's
        ``hRows``/``hCols`` (``MyLdpc.cpp:188-220``)."""
        if self.extra_blocks or self.masked_rows:
            rows, cols = np.nonzero(self.h_dense())
            return rows.astype(np.int64), cols.astype(np.int64)
        z = self.z
        rows_out = []
        cols_out = []
        for i in range(self.m_b):
            cols_i, shifts_i = self.layer(i)
            for r in range(z):
                grow = i * z + r
                gcols = cols_i * z + (r + shifts_i) % z
                rows_out.append(np.full(len(cols_i), grow, dtype=np.int64))
                cols_out.append(gcols.astype(np.int64))
        return np.concatenate(rows_out), np.concatenate(cols_out)

    def syndrome(self, codeword_bits: np.ndarray) -> np.ndarray:
        """H @ c mod 2 (numpy, for tests). codeword_bits: [..., n] 0/1.

        Computed block-sparse (one circulant gather + XOR per edge block,
        O(edges * batch)); densifying H would need [m, n] storage — 2 GB
        for DVB-S2 n=64800 — for the same result."""
        bits = np.asarray(codeword_bits).astype(np.uint8) & 1
        syn = np.zeros(bits.shape[:-1] + (self.m,), np.uint8)
        z = self.z
        br, bc, sh = self.blocks
        masks = self.block_row_masks
        r = np.arange(z)
        for e in range(len(br)):
            contrib = bits[..., bc[e] * z + (r + sh[e]) % z]
            if masks[e] is not None:
                contrib = contrib & masks[e]
            syn[..., br[e] * z: (br[e] + 1) * z] ^= contrib
        return syn

    def describe(self) -> str:
        return (
            f"QCCode({self.name}: n={self.n}, k={self.k}, z={self.z}, "
            f"rate={self.rate:.3f}, blocks={self.num_blocks}, "
            f"edges={self.num_edges})"
        )
