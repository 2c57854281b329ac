"""DVB-S2 IRA LDPC codes (EN 302 307; n = 64800 / 16200) in z=360 QC form.

Counterpart of ``myldpccppapi_tpu/codes/dvbs2.py``.  The construction
(address-table parsing, the synthetic girth-aware tables with the same
seeds, the row-residue QC transformation, the standard-order interleave and
the NumPy encoder) is a NumPy copy, so both packages build the same codes
and fingerprint the same tables.  :func:`ira_encode_fn` is torch on the
caller's device.

:func:`dvbs2` gives the exact EN 302 307 H structure -- information bits
addressed in groups of 360 with q-periodic row spreading plus a bidiagonal
parity accumulator -- as a :class:`QCCode` under the classic row-residue
permutation:

* info address a of group g  ->  block (a % q, g), shift (-(a // q)) % 360;
  two addresses of one group in one residue class give a MULTI-EDGE block
  (two circulants in one base cell, ``extra_blocks``);
* accumulator row i          ->  the dual diagonal of parity block-columns,
  shift 0;
* the accumulator's wrap     ->  block (0, kb+q-1), shift z-1, minus its
  first check row: a row-masked partial circulant (``masked_rows``).

The per-rate *address tables are synthetic*: deterministic girth-aware
draws with the standard's group structure and per-rate degree profile
(Table 5a/5b), NOT the EN 302 307 Annex B/C tables (PROVENANCE.md).  The
table is plain data: :func:`parse_address_table` takes the standard's.

The EN 302 307 §5.3.3 bit interleaver (:func:`bit_interleave`,
:func:`bit_deinterleave`) works on torch tensors of bits or LLRs; it is
BICM-ID's interleaver hook (ops/bicm_id.py).

:func:`dvbs2_oracle` builds the same code in the standard (un-permuted)
domain as a :class:`DVBS2Code`, which the generic edge-list decoder
(ops/bp_edgelist.py) serves, its layers the row residues mod q (360 rows
a layer): the independent test oracle that pins the QC transformation,
not a production path.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from .qc import QCCode

__all__ = ["BIT_INTERLEAVER_COLS", "DVBS2Code", "bit_deinterleave",
           "bit_interleave", "dvbs2", "dvbs2_ira_qc", "dvbs2_oracle",
           "ira_encode_fn", "ira_encode_numpy", "parse_address_table",
           "std_interleave", "synthetic_address_table", "table_4cycles"]

_GROUP = 360

# EN 302 307 Table 5b: short-frame (n=16200) k_ldpc per nominal rate -- the
# effective rate differs from the label (e.g. "1/2" short is k=7200).
_SHORT_K_LDPC = {
    "1/4": 3240, "1/3": 5400, "2/5": 6480, "1/2": 7200, "3/5": 9720,
    "2/3": 10800, "3/4": 11880, "4/5": 12600, "5/6": 13320, "8/9": 14400,
}

#: EN 302 307 Table 5a/5b information-node degree profiles (degree of the
#: heavy groups, count of heavy groups) per (n, rate); the remaining groups
#: have degree 3.  Used to make the synthetic tables structurally faithful.
_DEGREE_PROFILES = {
    (64800, "1/4"): (12, 15), (64800, "1/3"): (12, 20),
    (64800, "2/5"): (12, 24), (64800, "1/2"): (8, 36),
    (64800, "3/5"): (12, 36), (64800, "2/3"): (13, 12),
    (64800, "3/4"): (12, 15), (64800, "4/5"): (11, 18),
    (64800, "5/6"): (13, 15), (64800, "8/9"): (4, 20),
    (64800, "9/10"): (4, 18),
    (16200, "1/2"): (8, 20), (16200, "1/3"): (12, 12),
    (16200, "2/3"): (13, 3), (16200, "3/4"): (12, 3),
    (16200, "4/5"): (3, 0), (16200, "5/6"): (13, 5),
    (16200, "8/9"): (4, 9),
}


def _k_ldpc(n: int, rate: str) -> int:
    num, den = map(int, rate.split("/"))
    return _SHORT_K_LDPC[rate] if n == 16200 else n * num // den


def parse_address_table(text: str) -> Tuple[Tuple[int, ...], ...]:
    """Parse an EN 302 307 Annex B/C address table: one line per bit group
    of parity-accumulator addresses.  Returns the ``addresses`` tuple
    accepted by :func:`dvbs2_ira_qc` and :func:`dvbs2`.

    Addresses may be separated by whitespace, commas or semicolons; ``#``
    and ``%`` start comments, inline too; non-numeric header lines are
    skipped; group degrees may vary by row; negative addresses raise."""
    rows = []
    for line in text.strip().splitlines():
        for c in "#%":
            line = line.split(c, 1)[0]
        line = line.replace(",", " ").replace(";", " ").strip()
        if not line:
            continue
        toks = line.split()
        try:
            int(toks[0])
        except ValueError:
            continue  # header line
        row = tuple(int(tok) for tok in toks)
        if any(a < 0 for a in row):
            raise ValueError(f"negative accumulator address in line {line!r}")
        rows.append(row)
    if not rows:
        raise ValueError("no address-table rows found")
    return tuple(rows)


def _count_std_4cycles(addresses, k: int, m: int) -> int:
    """Exact 4-cycle count of the lifted standard-domain H (info spreading
    plus parity accumulator): a column pair sharing c >= 2 rows contributes
    C(c, 2) cycles.  Girth >= 6 iff this returns 0.

    The same count as the reference's ``_count_std_4cycles``, vectorised:
    the edges sorted by (row, column), every in-row column pair (c1 < c2)
    keyed as ``c1 * n + c2`` and counted once per row."""
    q = m // _GROUP
    n = k + m
    t = np.arange(_GROUP, dtype=np.int64)
    rows, cols = [], []
    for g, addrs in enumerate(addresses):
        a = np.asarray(addrs, dtype=np.int64)[:, None]
        rows.append(((a + t * q) % m).ravel())
        cols.append(np.broadcast_to(g * _GROUP + t, (a.shape[0], _GROUP)).ravel())
    p = np.arange(m, dtype=np.int64)  # accumulator: parity col p checks rows p, p+1
    rows += [p, p[1:]]
    cols += [k + p, k + p[:-1]]
    key = np.unique(np.concatenate(rows) * n + np.concatenate(cols))
    rows, cols = key // n, key % n
    pairs = []
    for d in range(1, len(key)):
        same = rows[d:] == rows[:-d]
        if not same.any():
            break
        pairs.append(cols[:-d][same] * n + cols[d:][same])
    if not pairs:
        return 0
    _, shared = np.unique(np.concatenate(pairs), return_counts=True)
    return int((shared * (shared - 1) // 2).sum())


@functools.lru_cache(maxsize=None)
def synthetic_address_table(n: int, rate: str,
                            seed: int = 0) -> Tuple[Tuple[int, ...], ...]:
    """Deterministic address table with the standard's group structure and
    degree profile (NOT the Annex B/C values; see the module docstring).

    Drawn girth-aware, with the reference's seeds: candidate tables are
    redrawn until the lifted H has no 4-cycles; when 24 draws cannot reach
    girth 6 (dense high-rate short frames), the least-cyclic draw is kept
    and a ``UserWarning`` reports its 4-cycle count."""
    num, den = map(int, rate.split("/"))
    k = _k_ldpc(n, rate)
    m = n - k
    groups = k // _GROUP
    deg_heavy, n_heavy = _DEGREE_PROFILES.get((n, rate), (8, groups // 3))
    best, best_cycles = None, None
    for attempt in range(24):
        rng = np.random.default_rng(302307 + n + 100 * num + den
                                    + 7919 * attempt + 104729 * seed)
        addrs = []
        for g in range(groups):
            deg = deg_heavy if g < n_heavy else 3
            a = rng.choice(m, size=deg, replace=False)
            addrs.append(tuple(int(x) for x in a))
        cycles = _count_std_4cycles(addrs, k, m)
        if cycles == 0:
            return tuple(addrs)
        if best_cycles is None or cycles < best_cycles:
            best, best_cycles = tuple(addrs), cycles
    warnings.warn(
        f"dvbs2 n={n} rate={rate}: no girth-6 table in 24 draws; using the "
        f"least-cyclic candidate ({best_cycles} residual 4-cycles)",
        stacklevel=2,
    )
    return best


def table_4cycles(n: int, rate: str, seed: int = 0) -> int:
    """Exact 4-cycle count of the synthetic default table for (n, rate):
    0 means the table is girth >= 6."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        addrs = synthetic_address_table(n, rate, seed)
    k = _k_ldpc(n, rate)
    return _count_std_4cycles(addrs, k, n - k)


def dvbs2_ira_qc(n: int = 64800, rate: str = "1/2",
                 addresses: "Tuple[Tuple[int, ...], ...] | str | None" = None
                 ) -> QCCode:
    """EN 302 307-structured IRA code as a z=360 :class:`QCCode`.

    ``addresses``: the published Annex B/C table (via
    :func:`parse_address_table`) for the bit-true standard code; None for
    the default -- the PEXIT-designed table where one exists
    (:mod:`.dvbs2_designed`: 16200 r1/2 and r1/3), else the synthetic one;
    ``"legacy"`` forces the synthetic table."""
    if addresses is None:
        from .dvbs2_designed import DESIGNED_ADDRESSES

        addresses = DESIGNED_ADDRESSES.get((n, rate))
        if addresses is None:
            addresses = synthetic_address_table(n, rate)
    elif isinstance(addresses, str):
        if addresses != "legacy":
            raise ValueError(f"unknown addresses {addresses!r}")
        addresses = synthetic_address_table(n, rate)
    num, den = map(int, rate.split("/"))
    k = _k_ldpc(n, rate)
    m = n - k
    if k != len(addresses) * _GROUP:
        raise ValueError(
            f"address table has {len(addresses)} groups, expected {k // _GROUP}"
        )
    q = m // _GROUP
    kb = k // _GROUP
    z = _GROUP
    base = np.full((q, kb + q), -1, dtype=np.int32)
    extra = []
    for g, addrs in enumerate(addresses):
        for a in addrs:
            if not 0 <= a < m:
                raise ValueError(f"group {g}: address {a} out of [0, {m})")
            l, s = a % q, (-(a // q)) % z
            if base[l, g] < 0:
                base[l, g] = s
            elif base[l, g] == s:
                raise ValueError(
                    f"group {g}: duplicate address residue (l={l}, s={s}); "
                    "coincident circulants cancel over GF(2)"
                )
            else:
                extra.append((l, g, s))
    # accumulator dual diagonal (all shift 0) + masked wrap block
    for a in range(q):
        base[a, kb + a] = 0
        if a + 1 < q:
            base[a + 1, kb + a] = 0
    wrap = (0, kb + q - 1, z - 1)
    base[wrap[0], wrap[1]] = wrap[2]
    return QCCode(
        name=f"dvbs2ira_n{n}_r{num}{den}",
        base=base,
        z=z,
        extra_blocks=tuple(extra) if extra else None,
        masked_rows=((wrap, (0,)),),
    )


def dvbs2(n: int = 64800, rate: str = "1/2",
          addresses: "Tuple[Tuple[int, ...], ...] | str | None" = None
          ) -> QCCode:
    """The DVB-S2 constructor (alias of :func:`dvbs2_ira_qc`): n = 64800
    (normal FECFRAME) or 16200 (short); encode with :func:`ira_encode_fn`."""
    return dvbs2_ira_qc(n, rate, addresses)


def std_interleave(n: int, k: int) -> np.ndarray:
    """``perm[p_std] = p_internal``: where standard codeword position
    ``p_std`` lives in the internal QC order.

    Information bits keep their order; standard parity bit i (position
    k+i) lives in internal parity block (i % q) at lane (i // q).  Usage:
    ``std = internal[..., perm]`` and ``internal = std[..., argsort(perm)]``
    (the same maps apply to LLRs on the receive side)."""
    m = n - k
    q = m // _GROUP
    perm = np.empty(n, dtype=np.int64)
    perm[:k] = np.arange(k)
    i = np.arange(m)
    perm[k:] = k + (i % q) * _GROUP + i // q
    return perm


#: EN 302 307 §5.3.3 bit-interleaver column counts per constellation
#: (QPSK is not interleaved)
BIT_INTERLEAVER_COLS = {"8psk": 3, "16apsk": 4, "32apsk": 5}


def _column_index(nc: int, col_order, device, inverse: bool) -> torch.Tensor:
    """The column write order (or its inverse) as an index tensor."""
    if sorted(col_order) != list(range(nc)):
        raise ValueError(f"col_order must permute 0..{nc - 1}")
    order = np.asarray(col_order, dtype=np.int64)
    return torch.as_tensor(np.argsort(order) if inverse else order, device=device)


def bit_interleave(bits: torch.Tensor, nc: int, col_order=None) -> torch.Tensor:
    """EN 302 307 §5.3.3 block bit interleaver: the FECFRAME is written
    column by column into an ``N/nc x nc`` array and read row by row, so
    each transmitted symbol takes one bit from each column (one bit from
    each of ``nc`` equal spans of the codeword).

    ``col_order``: optional column write order (the standard's 8PSK rate
    3/5 case, Table 8, is a non-identity order; it is data here).  Works on
    bits and LLR tensors alike ([..., N])."""
    lead, n = bits.shape[:-1], bits.shape[-1]
    if n % nc:
        raise ValueError(f"frame length {n} not divisible by {nc} columns")
    m = bits.reshape(*lead, nc, n // nc)
    if col_order is not None:
        m = m[..., _column_index(nc, col_order, bits.device, True), :]
    return m.transpose(-1, -2).reshape(*lead, n)


def bit_deinterleave(llr: torch.Tensor, nc: int, col_order=None) -> torch.Tensor:
    """Inverse of :func:`bit_interleave` (receive side, applied to LLRs)."""
    lead, n = llr.shape[:-1], llr.shape[-1]
    if n % nc:
        raise ValueError(f"frame length {n} not divisible by {nc} columns")
    m = llr.reshape(*lead, n // nc, nc).transpose(-1, -2)
    if col_order is not None:
        m = m[..., _column_index(nc, col_order, llr.device, False), :]
    return m.reshape(*lead, n)


def _info_entries(code: QCCode):
    """Per layer, the (block column, shift) of its information circulants
    in block order (the accumulator columns carry no info contribution)."""
    kb = code.k // code.z
    br, bc, sh = code.blocks
    per_layer = [[] for _ in range(code.m_b)]
    for e in range(len(br)):
        if int(bc[e]) < kb:
            per_layer[int(br[e])].append((int(bc[e]), int(sh[e])))
    return per_layer


def ira_encode_numpy(code: QCCode, u: np.ndarray) -> np.ndarray:
    """O(n) encode for :func:`dvbs2_ira_qc` codes: blockwise info row sums,
    prefix-XOR accumulator in standard row order, residue-permuted back to
    the internal QC parity layout.  Returns the INTERNAL-order codeword
    (H @ c = 0 for the QCCode's H); apply :func:`std_interleave` for the
    transmitted standard order."""
    u = np.asarray(u)
    z = code.z
    q = code.m_b
    kb = code.k // z
    flat = np.ascontiguousarray(u.reshape(-1, code.k) & 1, dtype=np.uint8)
    b = flat.shape[0]
    ub = flat.reshape(b, kb, z)
    lams = []
    for entries in _info_entries(code):
        acc = np.zeros((b, z), np.uint8)
        for (g, s) in entries:
            acc ^= np.roll(ub[:, g, :], -s, axis=-1)
        lams.append(acc)
    lam = np.stack(lams, axis=1)  # [b, q, z]
    # standard row order: i = u_pos * q + l  ->  transpose
    lam_std = np.ascontiguousarray(lam.transpose(0, 2, 1)).reshape(b, q * z)
    p_std = np.bitwise_xor.accumulate(lam_std, axis=-1)
    p_int = np.ascontiguousarray(
        p_std.reshape(b, z, q).transpose(0, 2, 1)
    ).reshape(b, q * z)
    out = np.concatenate([flat, p_int], axis=-1).astype(u.dtype)
    return out.reshape(*u.shape[:-1], code.n)


def ira_encode_fn(code: QCCode):
    """Torch version of :func:`ira_encode_numpy`: [..., k] 0/1 info bits
    (any integer dtype, any device) -> [..., n] internal-order codeword
    bits, uint8, on the same device.  Per layer an XOR of rolled info
    blocks, then the accumulator as a prefix XOR (an int32 cumulative sum
    mod 2) in standard row order."""
    z = code.z
    q = code.m_b
    kb = code.k // z
    per_layer = _info_entries(code)

    def encode(u: torch.Tensor) -> torch.Tensor:
        lead = u.shape[:-1]
        ub = (u.reshape(*lead, kb, z) & 1).to(torch.uint8)
        lams = []
        for entries in per_layer:
            acc = torch.zeros(lead + (z,), dtype=torch.uint8, device=u.device)
            for (g, s) in entries:
                acc = acc ^ torch.roll(ub[..., g, :], -s, dims=-1)
            lams.append(acc)
        lam = torch.stack(lams, dim=-2)  # [..., q, z]
        lam_std = lam.transpose(-1, -2).reshape(*lead, q * z)
        p_std = (torch.cumsum(lam_std, dim=-1, dtype=torch.int32) & 1).to(torch.uint8)
        p_int = p_std.reshape(*lead, z, q).transpose(-1, -2).reshape(*lead, q * z)
        return torch.cat([ub.reshape(*lead, code.k), p_int], dim=-1)

    return encode


@dataclasses.dataclass(frozen=True, eq=False)
class DVBS2Code:
    """IRA code in the standard domain: H = [H_info | H_acc], accumulator
    bidiagonal parity (a NumPy copy of the reference's ``DVBS2Code``)."""

    name: str
    n: int
    k: int
    #: per info-group address lists: addresses[g] = row indices of bit g*360
    addresses: Tuple[Tuple[int, ...], ...]

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def q(self) -> int:
        return self.m // _GROUP

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def k_info(self) -> int:
        return self.k

    @property
    def info_positions(self) -> np.ndarray:
        return np.arange(self.k, dtype=np.int64)

    @cached_property
    def info_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the information part of H."""
        m, q = self.m, self.q
        rows, cols = [], []
        for g, addrs in enumerate(self.addresses):
            j = np.arange(_GROUP, dtype=np.int64)
            for a in addrs:
                rows.append((a + j * q) % m)
                cols.append(g * _GROUP + j)
        return np.concatenate(rows), np.concatenate(cols)

    def h_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full H edge list (info part + accumulator), row-major sorted."""
        ir, ic = self.info_edges
        m = self.m
        acc_rows = np.concatenate([np.arange(m), np.arange(1, m)])
        acc_cols = np.concatenate(
            [self.k + np.arange(m), self.k + np.arange(m - 1)]
        )
        rows = np.concatenate([ir, acc_rows])
        cols = np.concatenate([ic, acc_cols])
        order = np.lexsort((cols, rows))
        return rows[order], cols[order]

    @cached_property
    def edge_index(self):
        """Padded edge tables with mod-q layered grouping (360 rows/layer)."""
        from ..ops.bp_edgelist import build_edge_index

        rows, cols = self.h_coo()
        layer = (np.arange(self.m) % self.q).astype(np.int32)
        return build_edge_index(rows, cols, self.n, self.m, layer)

    # -- encoding ----------------------------------------------------------
    def encode_numpy(self, u: np.ndarray) -> np.ndarray:
        """[..., k] info bits -> [..., n]: scatter + prefix-XOR accumulator."""
        u = np.asarray(u)
        rows, cols = self.info_edges
        flat_u = u.reshape(-1, self.k).astype(np.int64)
        flat_lam = np.zeros((flat_u.shape[0], self.m), dtype=np.int64)
        np.add.at(flat_lam.T, rows, flat_u.T[cols])
        p = np.cumsum(flat_lam, axis=-1) & 1
        out = np.concatenate([flat_u & 1, p], axis=-1).astype(u.dtype)
        return out.reshape(*u.shape[:-1], self.n)

    def encode_fn(self):
        """Torch encoder: [B, k] 0/1 info bits (any integer dtype, any
        device) -> [B, n] codeword bits, uint8, on the same device.  The
        parity is the prefix XOR of the rows' information sums: one integer
        cumulative sum over the information edges sorted by row, read at
        each row's end, mod 2 (no scatter)."""
        rows, cols = self.info_edges
        order = np.argsort(rows, kind="stable")
        ends = np.cumsum(np.bincount(rows, minlength=self.m))  # [m]
        dev = {}

        def encode(u: torch.Tensor) -> torch.Tensor:
            if u.device not in dev:
                dev[u.device] = (torch.as_tensor(cols[order], device=u.device),
                                 torch.as_tensor(ends, device=u.device))
            cols_t, ends_t = dev[u.device]
            bits = (u & 1).to(torch.int32)
            csum = torch.cumsum(bits[:, cols_t], dim=-1, dtype=torch.int32)
            csum = torch.cat([csum.new_zeros((u.shape[0], 1)), csum], dim=-1)
            p = csum[:, ends_t] & 1
            return torch.cat([bits, p], dim=-1).to(torch.uint8)

        return encode

    def syndrome(self, cw: np.ndarray) -> np.ndarray:
        """H @ c mod 2 via the edge list (numpy, for tests)."""
        rows, cols = self.h_coo()
        cw = np.asarray(cw)
        flat = cw.reshape(-1, self.n).astype(np.int64)
        syn = np.zeros((flat.shape[0], self.m), dtype=np.int64)
        np.add.at(syn.T, rows, flat.T[cols])
        return (syn & 1).reshape(*cw.shape[:-1], self.m)

    def describe(self) -> str:
        e = len(self.info_edges[0]) + 2 * self.m - 1
        return (
            f"DVBS2Code({self.name}: n={self.n}, k={self.k}, q={self.q}, "
            f"rate={self.rate:.3f}, edges~{e})"
        )


def dvbs2_oracle(n: int = 64800, rate: str = "1/2") -> DVBS2Code:
    """Standard-domain (un-permuted) DVB-S2 code on the generic edge-list
    path -- the independent test oracle for :func:`dvbs2`'s QC
    transformation (the same default address tables, designed or
    synthetic), not a production decoder.  Use :func:`dvbs2` everywhere
    else."""
    num, den = map(int, rate.split("/"))
    if n == 16200:
        if rate not in _SHORT_K_LDPC:
            raise ValueError(f"unknown short-frame rate {rate!r}")
        k = _SHORT_K_LDPC[rate]
    else:
        k = n * num // den
    if (n - k) % _GROUP or k % _GROUP:
        raise ValueError(f"n={n} rate={rate}: k and m must be multiples of 360")
    from .dvbs2_designed import DESIGNED_ADDRESSES

    return DVBS2Code(
        name=f"dvbs2_n{n}_r{num}{den}",
        n=n,
        k=k,
        addresses=DESIGNED_ADDRESSES.get((n, rate))
        or synthetic_address_table(n, rate),
    )
