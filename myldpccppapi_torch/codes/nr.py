"""5G-NR-style LDPC: BG1/BG2-structured base graphs, lifting, rate matching.

Counterpart of ``myldpccppapi_tpu/codes/nr.py``.  The construction
(lifting sets, the table parser, the synthetic base graphs with the same
seeds, the lifting rule, the triangular check and the NumPy encoder) is a
NumPy copy, so both packages build the same codes.  The runtime pieces are
torch ops on the caller's device: :func:`triangular_encode_fn`,
:func:`rate_match_bits`, :func:`rate_match_llr` and :func:`harq_combine`.

The base-graph *connectivity and shift tables here are synthetic*: they
have the structural properties of the standard's BG1/BG2 (dense
high-degree first two columns, degree-3 extension rows, lower-triangular
parity part) but are NOT the 3GPP tables (PROVENANCE.md).  Everything
downstream treats the table as data, so dropping in the standard's tables
(:func:`parse_bg_table`) is a data change only.
"""
from __future__ import annotations

import numpy as np
import torch

from .qc import QCCode

__all__ = [
    "nr_base_graph",
    "nr_code",
    "triangular_encode_fn",
    "triangular_encode_numpy",
    "rate_match_llr",
    "rate_match_bits",
    "harq_combine",
    "rv_start",
    "lifting_set_index",
    "parse_bg_table",
    "NR_ZMAX",
    "NR_LIFTING_SETS",
]

NR_ZMAX = 384

_BG_SHAPES = {1: (46, 68, 22), 2: (42, 52, 10)}

#: TS 38.212 Table 5.3.2-1: supported lifting sizes Z = a * 2^j, grouped
#: into 8 sets by a in {2, 3, 5, 7, 9, 11, 13, 15}; the published shift
#: tables give one value column V per set, and the applied shift is
#: ``V mod Z``.
NR_LIFTING_SETS = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)


def lifting_set_index(z: int) -> int:
    """iLS of a supported lifting size (TS 38.212 Table 5.3.2-1)."""
    for i, zs in enumerate(NR_LIFTING_SETS):
        if z in zs:
            return i
    raise ValueError(f"Z={z} is not a 38.212 lifting size")


def parse_bg_table(text: str) -> np.ndarray:
    """Parse a TS 38.212-style base-graph shift table.

    Three formats are accepted, and all fingerprint identically via
    :func:`.tables.table_fingerprint` once parsed:

    * **canonical sparse**: ``row col v0 v1 ... v7`` — one line per
      non-null entry, one V column per lifting set -> ``[m_b, n_b, 8]``;
    * **per-set sparse**: ``row col V`` — one lifting set per file ->
      ``[m_b, n_b]`` (feed to :func:`nr_code` directly; the applied shift
      is ``V mod z``);
    * **dense matrix**: ``m_b`` lines of ``n_b`` shifts with ``-1`` nulls
      -> ``[m_b, n_b]``.

    Tokens may be separated by whitespace, commas, or semicolons; ``#``
    and ``%`` start comments (inline too); lines whose first token is not
    an integer (column headers) are skipped; duplicate ``(row, col)``
    entries raise — a silent overwrite is exactly the transcription
    corruption this loader exists to prevent.
    """
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
            continue  # column-header line ("Row Col V0 ...")
        try:
            rows.append([int(t) for t in toks])
        except ValueError as e:
            raise ValueError(f"non-integer token in table line {line!r}: {e}")
    if not rows:
        raise ValueError("no table entries found")
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise ValueError(
            f"inconsistent column counts {sorted(widths)}: expected one of "
            "the documented formats (row col v0..v7 / row col V / dense)"
        )
    w = widths.pop()
    if w in (3, 10):  # sparse: row col V... (V per lifting set or single)
        nv = w - 2
        for r in rows:
            if r[0] < 0 or r[1] < 0:
                # Python negative indexing would silently write the LAST
                # row/col
                raise ValueError(
                    f"negative (row, col)=({r[0]}, {r[1]}) in table entry"
                )
            if any(v < -1 for v in r[2:]):
                raise ValueError(
                    f"shift value < -1 in entry (row, col)=({r[0]}, {r[1]})"
                )
        m_b = max(r[0] for r in rows) + 1
        n_b = max(r[1] for r in rows) + 1
        shape = (m_b, n_b, 8) if nv == 8 else (m_b, n_b)
        table = np.full(shape, -1, dtype=np.int32)
        seen = set()
        for r in rows:
            key = (r[0], r[1])
            if key in seen:
                raise ValueError(f"duplicate entry for (row, col)={key}")
            seen.add(key)
            table[key] = r[2:] if nv == 8 else r[2]
        return table
    if w in (9, 11):
        # one token away from the sparse widths: almost certainly a
        # uniformly truncated/extended sparse file, not a 9/11-column
        # dense base graph — refuse rather than misparse
        raise ValueError(
            f"every line has {w} tokens — one off from the sparse formats "
            "(3 or 10); refusing to guess (a uniformly truncated sparse "
            "table would otherwise silently parse as a dense matrix)"
        )
    dense = np.asarray(rows, dtype=np.int32)
    if (dense < -1).any():
        raise ValueError("dense table contains values < -1")
    return dense


def _fill_girth6_shifts(base, rng, zmax) -> None:
    """Assign shifts to the ``-2``-marked cells of ``base`` (in place) so
    the lifted graph at lifting size ``zmax`` has no 4-cycles (girth >= 6).

    Block rows i1, i2 sharing columns j1, j2 form z 4-cycles iff
    ``s[i1,j1] - s[i1,j2] + s[i2,j2] - s[i2,j1] == 0 (mod z)``; filling cell
    (i, j) forbids one value per (other row, shared column) pair.  The
    draw order and RNG calls are the reference's, so both packages pick
    the same shifts.
    """
    m_b, n_b = base.shape
    for i in range(m_b):
        for j in range(n_b):
            if base[i, j] != -2:
                continue
            forbidden = set()
            for i2 in range(m_b):
                if i2 == i or base[i2, j] < 0:
                    continue
                for j2 in range(n_b):
                    if j2 != j and base[i, j2] >= 0 and base[i2, j2] >= 0:
                        forbidden.add(
                            (base[i, j2] - base[i2, j2] + base[i2, j]) % zmax
                        )
            allowed = [s for s in range(zmax) if s not in forbidden]
            if not allowed:
                raise RuntimeError("girth-6 fill exhausted the shift range")
            base[i, j] = int(rng.choice(allowed))


#: Default synthetic-table seed per base graph (the reference's, chosen
#: there by measured FER among four girth-6 candidates).
_DEFAULT_TABLE_SEED = {1: 3, 2: 0}

#: Shift seed for the PEXIT-designed supports (codes/nr_designed.py).
_DESIGNED_SHIFT_SEED = {2: 0}


def nr_base_graph(bg: int = 1, zmax: int = NR_ZMAX,
                  seed: "int | None" = None,
                  support: "np.ndarray | str | None" = None) -> np.ndarray:
    """Synthetic BG1/BG2-structured base matrix with shifts in [0, zmax).

    Structure (TS 38.212's shape, not its values): systematic columns
    first, columns 0 and 1 high-degree (the punctured ones); a
    lower-bidiagonal shift-0 core-parity staircase; one identity column
    per extension row.

    ``support``: ``None`` (default) lifts the PEXIT-designed support where
    one exists (:mod:`.nr_designed`, BG2), else the legacy random-profile
    synthetic; ``"legacy"`` forces the latter; a boolean [m_b, n_b] array
    lifts that support.  Non-diagonal cells get shifts that are 4-cycle
    free at ``zmax`` (:func:`_fill_girth6_shifts`).
    """
    m_b, n_b, k_b = _BG_SHAPES[bg]
    if support is None:
        from .nr_designed import DESIGNED_SUPPORT, designed_support

        support = designed_support(bg) if bg in DESIGNED_SUPPORT else "legacy"
    if isinstance(support, str):
        if support != "legacy":
            raise ValueError(f"unknown support {support!r}")
        support = None
    if seed is None:
        seed = (_DESIGNED_SHIFT_SEED.get(bg, _DEFAULT_TABLE_SEED[bg])
                if support is not None else _DEFAULT_TABLE_SEED[bg])
    rng = np.random.default_rng(38212 + bg + 7919 * seed)
    # -1 = zero block, -2 = present (shift chosen girth-aware below)
    base = np.full((m_b, n_b), -1, dtype=np.int32)

    if support is not None:
        support = np.asarray(support, dtype=bool)
        if support.shape != (m_b, n_b):
            raise ValueError(f"BG{bg} support must be [{m_b}, {n_b}]")
        base[support] = -2
    else:
        # core rows: dense over systematic columns
        for i in range(4):
            cols = set(range(0, 2)) | set(
                rng.choice(np.arange(2, k_b), size=max(k_b - 5, 2),
                           replace=False)
            )
            for j in cols:
                base[i, j] = -2
        # extension rows
        for r in range(4, m_b):
            cols = {r % 2}  # protect the punctured columns 0/1
            cols |= set(rng.choice(np.arange(2, k_b), size=3, replace=False))
            if rng.random() < 0.4:
                cols.add(int(k_b + rng.integers(0, 4)))
            for j in cols:
                base[r, j] = -2
    # core parity staircase (shift 0 diagonals -> trivially invertible)
    for i in range(4):
        base[i, k_b + i] = 0
        if i + 1 < 4:
            base[i + 1, k_b + i] = 0
    # identity extension columns
    for r in range(4, m_b):
        base[r, k_b + 4 + (r - 4)] = 0
    _fill_girth6_shifts(base, rng, zmax)
    return base


def nr_code(z: int = 384, bg: int = 1,
            table: "np.ndarray | None" = None) -> QCCode:
    """Lift a base graph to size ``z`` per the 38.212 rule: the applied
    shift of a non-null entry is ``V mod z`` with V taken from the lifting
    set of ``z`` (``lifting_set_index``).

    ``table`` may be a [m_b, n_b, 8] per-set V array (the output of
    :func:`parse_bg_table` on the published tables) or a [m_b, n_b]
    single-V array; default is the synthetic :func:`nr_base_graph`.
    """
    m_b, n_b, k_b = _BG_SHAPES[bg]
    if table is None:
        raw = nr_base_graph(bg)
    elif np.asarray(table).ndim == 3:
        tab = np.asarray(table)
        if tab.shape[:2] != (m_b, n_b):
            raise ValueError(f"BG{bg} table must be [{m_b}, {n_b}, 8]")
        raw = tab[:, :, lifting_set_index(z)]
    else:
        raw = np.asarray(table)
        if raw.shape != (m_b, n_b):
            raise ValueError(
                f"BG{bg} single-set table must be [{m_b}, {n_b}], "
                f"got {list(raw.shape)}"
            )
    base = np.where(raw >= 0, raw % z, -1).astype(np.int32)
    return QCCode(
        name=f"nr_bg{bg}_z{z}",
        base=base,
        z=z,
        punctured_front=2 * z,
    )


# ---------------------------------------------------------------------------
# Encoding: sparse block back-substitution over the triangular parity part
# ---------------------------------------------------------------------------

def _check_triangular(code: QCCode) -> None:
    k_b = code.k // code.z
    pb = code.base[:, k_b:]
    m_b = code.m_b
    for i in range(m_b):
        if pb[i, i] != 0:
            raise ValueError("parity diagonal must be shift-0 identity blocks")
        if any(pb[i, j] >= 0 for j in range(i + 1, m_b)):
            raise ValueError("parity part must be lower block triangular")


def triangular_encode_numpy(code: QCCode, u: np.ndarray) -> np.ndarray:
    """[..., k] info bits -> [..., n] codeword via block back-substitution."""
    _check_triangular(code)
    z, k_b, m_b = code.z, code.k // code.z, code.m_b
    u = np.asarray(u)
    ub = u.reshape(*u.shape[:-1], k_b, z)
    blocks = [ub[..., j, :] for j in range(k_b)]
    for i in range(m_b):
        acc = np.zeros(ub.shape[:-2] + (z,), dtype=ub.dtype)
        for j in range(k_b + i):  # strictly-lower parity + all info blocks
            s = code.base[i, j]
            if s >= 0:
                acc = acc ^ np.roll(blocks[j], -s, axis=-1)
        blocks.append(acc)  # p_i: diagonal block is identity (shift 0)
    return np.concatenate(blocks, axis=-1)


def triangular_encode_fn(code: QCCode):
    """Torch version of :func:`triangular_encode_numpy`: [..., k] 0/1 info
    bits (any integer dtype, any device) -> [..., n] codeword bits, uint8,
    on the same device (``torch.roll`` and XOR per circulant)."""
    _check_triangular(code)
    z, k_b, m_b = code.z, code.k // code.z, code.m_b
    entries = [
        [(j, int(code.base[i, j])) for j in range(k_b + i) if code.base[i, j] >= 0]
        for i in range(m_b)
    ]

    def encode(u: torch.Tensor) -> torch.Tensor:
        ub = u.reshape(*u.shape[:-1], k_b, z).to(torch.uint8)
        blocks = [ub[..., j, :] for j in range(k_b)]
        for i in range(m_b):
            acc = torch.zeros(u.shape[:-1] + (z,), dtype=torch.uint8,
                              device=u.device)
            for (j, s) in entries[i]:
                acc = acc ^ torch.roll(blocks[j], -s, dims=-1)
            blocks.append(acc)
        return torch.stack(blocks, dim=-2).reshape(*u.shape[:-1], code.n)

    return encode


# ---------------------------------------------------------------------------
# Rate matching (TS 38.212 §5.4.2: circular buffer, redundancy versions)
# ---------------------------------------------------------------------------

#: TS 38.212 Table 5.4.2.1-2 numerators of the rv starting position
#: k0 = floor(num * Ncb / (den * Zc)) * Zc, indexed [bg][rv].
_RV_K0_NUM = {1: (0, 17, 33, 56), 2: (0, 13, 25, 43)}
_RV_K0_DEN = {1: 66, 2: 50}


def rv_start(code: QCCode, rv: int = 0, n_cb: "int | None" = None) -> int:
    """Circular-buffer starting position k0 of redundancy version ``rv``
    (TS 38.212 Table 5.4.2.1-2)."""
    if rv not in (0, 1, 2, 3):
        raise ValueError(f"rv must be 0..3, got {rv}")
    bg = 1 if code.n_b == 68 else 2
    z = code.z
    if n_cb is None:
        n_cb = code.n - code.punctured_front
    return (_RV_K0_NUM[bg][rv] * n_cb) // (_RV_K0_DEN[bg] * z) * z


def rate_match_bits(code: QCCode, cw: torch.Tensor, e: int, rv: int = 0,
                    n_cb: "int | None" = None) -> torch.Tensor:
    """[..., n] codeword -> [..., e] transmitted bits: skip the first 2Z
    punctured systematic bits, then read the circular buffer of length
    ``n_cb`` starting at rv's k0, wrapping as needed."""
    p = code.punctured_front
    buf = cw[..., p:]
    if n_cb is None:
        n_cb = buf.shape[-1]
    idx = (rv_start(code, rv, n_cb) + np.arange(e)) % n_cb
    return buf[..., torch.as_tensor(idx, device=cw.device)]


def harq_combine(code: QCCode, transmissions,
                 n_cb: "int | None" = None) -> torch.Tensor:
    """Soft-combine HARQ (re)transmissions into one decoder input.

    ``transmissions``: sequence of ``(llr_e, rv)`` pairs — the received
    [..., e_i] LLRs and redundancy version of each transmission of the SAME
    code block.  AWGN LLRs of independent observations add, so chase
    combining (same rv) and incremental redundancy (different rvs) are both
    this sum, taken in transmission order.  Returns the [..., n] decoder
    input.
    """
    out = None
    for llr_e, rv in transmissions:
        full = rate_match_llr(code, llr_e, llr_e.shape[-1], rv, n_cb)
        out = full if out is None else out + full
    if out is None:
        raise ValueError("at least one transmission required")
    return out


def rate_match_llr(code: QCCode, llr_e: torch.Tensor, e: "int | None" = None,
                   rv: int = 0, n_cb: "int | None" = None) -> torch.Tensor:
    """[..., e] received LLRs -> [..., n] decoder input.

    ``e`` (the transmitted length) is implied by ``llr_e`` and may be
    omitted; passing a mismatched value is rejected.

    Untransmitted buffer positions get LLR 0 (unknown); repeated positions
    accumulate (soft combining); the 2Z never-transmitted punctured bits
    get LLR 0 as well.  The circular buffer is walked in contiguous
    segments in transmission order: placed when no position repeats
    (``e <= n_cb``), else added segment by segment, so the sum at a
    repeated position is taken in transmission order on every device (no
    scatter-add, whose order on CUDA is not fixed).
    """
    if e is None:
        e = llr_e.shape[-1]
    elif e != llr_e.shape[-1]:
        raise ValueError(
            f"e={e} disagrees with llr_e.shape[-1]={llr_e.shape[-1]}"
        )
    p = code.punctured_front
    n_buf = code.n - p
    if n_cb is None:
        n_cb = n_buf
    k0 = rv_start(code, rv, n_cb)
    out = llr_e.new_zeros(llr_e.shape[:-1] + (code.n,))
    buf = out[..., p:]
    t, pos = 0, k0
    while t < e:
        length = min(n_cb - pos, e - t)
        seg = llr_e[..., t:t + length]
        if e <= n_cb:
            buf[..., pos:pos + length] = seg
        else:
            buf[..., pos:pos + length] += seg
        t += length
        pos = 0
    return out
