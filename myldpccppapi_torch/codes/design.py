"""PEXIT-guided protograph design: optimize base-graph supports.

Counterpart of ``myldpccppapi_tpu/codes/design.py``, a NumPy copy on the
port's own :mod:`.nr` and :mod:`.dvbs2` tables: with :mod:`.pexit`
pricing any protograph in milliseconds, the synthetic NR base graphs and
DVB-S2 IRA profiles are searched for a lower threshold under the TS 38.212
/ EN 302 307 structural constraints that keep the encoders, the 2Z front
puncture and the rate matcher working:

* columns 0/1 (the punctured systematic pair) stay high-degree,
* the 4x4 core-parity staircase and the identity extension columns are
  fixed (they ARE the encoder),
* extension rows keep bounded degree (sparsity = decode cost/iteration).

The search is greedy hill-climbing with move = relocate one edge of one
row (or one multiplicity unit of the IRA profile); each candidate is
priced by ONE pexit run at (current threshold - tol), full bisection only
on acceptance.  The seeds and move order are the reference's, so both
searches take the same steps.  Thresholds depend on the protograph only;
the lifted shifts are chosen downstream, unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .pexit import pexit_run, threshold_ebn0

__all__ = ["optimize_nr_support", "nr_support_default"]


def _nr_shapes(bg: int) -> Tuple[int, int, int]:
    from .nr import _BG_SHAPES

    return _BG_SHAPES[bg]


def nr_support_default(bg: int, seed: Optional[int] = None) -> np.ndarray:
    """Boolean support of the LEGACY profile-recall synthetic base graph
    (the search start point — not the already-designed default)."""
    from .nr import nr_base_graph

    return nr_base_graph(bg, seed=seed, support="legacy") >= 0


def _nr_fixed_and_bounds(bg: int):
    m_b, n_b, k_b = _nr_shapes(bg)
    fixed = np.zeros((m_b, n_b), dtype=bool)
    # core-parity staircase + identity extension columns are the encoder
    for i in range(4):
        fixed[i, k_b + i] = True
        if i + 1 < 4:
            fixed[i + 1, k_b + i] = True
    for r in range(4, m_b):
        fixed[r, k_b + 4 + (r - 4)] = True
    # mutable region: systematic + core-parity columns
    mutable_cols = np.arange(0, k_b + 4)
    return fixed, mutable_cols


def _valid(b: np.ndarray, bg: int) -> bool:
    m_b, n_b, k_b = _nr_shapes(bg)
    core = b[:4, : k_b + 4]
    ext = b[4:, : k_b + 4]
    # triangular encodability: core row i may touch parity columns only up
    # to its own staircase diagonal k_b + i
    for i in range(4):
        if b[i, k_b + i + 1: k_b + 4].any():
            return False
    # punctured columns need protection: high degree, and every extension
    # row keeps at least one of them is NOT required (the real BGs don't),
    # but the columns themselves must stay the best-connected
    if b[:, 0].sum() < m_b // 3 or b[:, 1].sum() < m_b // 3:
        return False
    # degree bounds: extension rows 3..7 over the mutable region (plus
    # their identity bit), core rows 8..k_b+2
    d_ext = ext.sum(axis=1)
    if d_ext.min() < 3 or d_ext.max() > 7:
        return False
    d_core = core.sum(axis=1)
    if d_core.min() < 6 or d_core.max() > k_b + 3:
        return False
    # every systematic/core-parity column must be reachable (degree >= 1;
    # transmitted systematic want >= 2 for BP to improve them at all)
    d_col = b[:, : k_b + 4].sum(axis=0)
    if d_col.min() < 1 or (d_col[2:k_b] < 2).any():
        return False
    return True


def _threshold(b: np.ndarray, bg: int, lo: float, hi: float,
               tol: float) -> float:
    m_b, n_b, k_b = _nr_shapes(bg)
    rate = (n_b - m_b) / (n_b - 2)
    return threshold_ebn0(
        b.astype(np.int64), rate=rate, punctured_cols=(0, 1),
        lo=lo, hi=hi, tol_db=tol,
    )


def _converges_at(b: np.ndarray, bg: int, ebn0_db: float) -> bool:
    m_b, n_b, k_b = _nr_shapes(bg)
    rate = (n_b - m_b) / (n_b - 2)
    s = np.full(n_b, 8.0 * rate * 10.0 ** (ebn0_db / 10.0))
    s[0] = s[1] = 0.0
    return pexit_run(b.astype(np.int64), s).converged


def optimize_nr_support(
    bg: int = 2,
    steps: int = 600,
    seed: int = 0,
    start: Optional[np.ndarray] = None,
    tol_db: float = 0.02,
    log_every: int = 0,
) -> Tuple[np.ndarray, float]:
    """Greedy threshold descent on the BG support.  Returns (support,
    threshold_ebn0_db).

    Moves (uniform mix): relocate one mutable edge within its row; add an
    edge to a row below its degree cap; drop an edge from a row above its
    floor.  A move is accepted iff the protograph converges strictly below
    the incumbent threshold (one pexit run for rejects).
    """
    rng = np.random.default_rng(seed)
    m_b, n_b, k_b = _nr_shapes(bg)
    fixed, mcols = _nr_fixed_and_bounds(bg)
    b = (start if start is not None else nr_support_default(bg)).copy()
    assert _valid(b, bg), "start support violates the structural constraints"
    thr = _threshold(b, bg, lo=-2.0, hi=10.0, tol=tol_db)

    for step in range(steps):
        cand = b.copy()
        r = int(rng.integers(0, m_b))
        row = cand[r, : k_b + 4]
        on = [j for j in np.flatnonzero(row) if not fixed[r, j]]
        off = [j for j in mcols if not row[j]]
        if not on or not off:
            continue
        kind = rng.random()
        if kind < 0.6:                      # relocate
            row[rng.choice(on)] = False
            row[rng.choice(off)] = True
        elif kind < 0.8:                    # add
            row[rng.choice(off)] = True
        else:                               # drop
            row[rng.choice(on)] = False
        if not _valid(cand, bg):
            continue
        if _converges_at(cand, bg, thr - tol_db):
            b = cand
            thr = _threshold(b, bg, lo=thr - 2.0, hi=thr, tol=tol_db)
            if log_every and (step % log_every == 0):
                print(f"[design] step {step}: threshold {thr:.3f} dB")
    return b, thr


# ---------------------------------------------------------------------------
# DVB-S2 IRA profile design
# ---------------------------------------------------------------------------

def _dvbs2_dims(n: int, rate: str):
    from .dvbs2 import _GROUP, _SHORT_K_LDPC

    num, den = map(int, rate.split("/"))
    k = _SHORT_K_LDPC[rate] if n == 16200 else n * num // den
    m = n - k
    return k, m, k // _GROUP, m // _GROUP, _GROUP


def _dvbs2_protograph(bi: np.ndarray, q: int, kb: int) -> np.ndarray:
    """Full protograph from the info multiplicity matrix: accumulator
    staircase appended (the wrap circulant counts as a full edge,
    O(1/z) like in :func:`.pexit.protograph`)."""
    b = np.zeros((q, kb + q), dtype=np.int64)
    b[:, :kb] = bi
    for a in range(q):
        b[a, kb + a] += 1
        if a + 1 < q:
            b[a + 1, kb + a] += 1
    b[0, kb + q - 1] += 1  # wrap
    return b


def dvbs2_start_profile(n: int, rate: str) -> np.ndarray:
    """Info-part multiplicity matrix [q, kb] of the current synthetic
    table (the search start point)."""
    import warnings

    from .dvbs2 import dvbs2_ira_qc, synthetic_address_table
    from .pexit import protograph

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        code = dvbs2_ira_qc(n, rate, synthetic_address_table(n, rate))
    k, m, kb, q, z = _dvbs2_dims(n, rate)
    return np.asarray(protograph(code)[:, :kb], dtype=np.int64)


def _dvbs2_valid(bi: np.ndarray, edge_cap: int, min_degree: int = 3) -> bool:
    col = bi.sum(axis=0)
    # EN 302 307 profile range caps at 13.  The info-degree FLOOR is a
    # FINITE-LENGTH knob, not a threshold one: low-degree info columns
    # improve the asymptotic threshold but, stacked on the degree-2
    # accumulator chain, produce low-weight codewords and a shallow
    # measured waterfall (results.jsonl dvbs2_design_eval: the min-2 and
    # min-3 designs both decay ~1 decade per 0.5 dB at n=16200 instead of
    # the legacy all-degree-8 table's cliff).  Raise it to buy slope with
    # threshold.
    if col.min() < min_degree or col.max() > 13:
        return False
    # connectivity DIVERSITY per group, invisible to PEXIT (multiplicity is
    # asymptotically equivalent) but fatal at finite length: a group whose
    # degree concentrates in 1-2 row classes forms low-weight structures
    # with the accumulator (measured: a deg-3 single-row-class group gave
    # the min-3 r1/2 design an FER floor ~0.09 at 1.5 dB, results.jsonl
    # dvbs2_design_eval).  Require >= 3 distinct row classes per group and
    # at most one doubled address (the standard's own multi-edge pattern).
    if (bi > 0).sum(axis=0).min() < 3:
        return False
    if bi.max() > 2:
        return False
    if bi.sum() > edge_cap:
        return False
    row = bi.sum(axis=1)
    if row.min() < 1:                     # every layer must see info bits
        return False
    return True


def optimize_dvbs2_profile(
    n: int = 16200,
    rate: str = "1/2",
    steps: int = 1500,
    seed: int = 0,
    start: Optional[np.ndarray] = None,
    edge_slack: int = 0,
    min_degree: int = 3,
    tol_db: float = 0.02,
    log_every: int = 0,
) -> Tuple[np.ndarray, float]:
    """Greedy threshold descent on the IRA info-part multiplicity matrix.

    Moves: relocate one multiplicity unit between cells; add one (within
    ``edge_slack`` of the start's edge count — per-iteration decode cost);
    drop one.  The accumulator staircase is fixed (it IS the encoder);
    column degrees stay in the standard's [2, 13] profile range.
    Returns (bi [q, kb], threshold_ebn0_db).
    """
    k, m, kb, q, z = _dvbs2_dims(n, rate)
    # the diversity rule (>= 3 distinct row classes/group) is unsatisfiable
    # below degree 3 — a smaller floor would spin the sanitizer forever
    min_degree = max(int(min_degree), 3)
    rng = np.random.default_rng(seed)
    bi = (start if start is not None else dvbs2_start_profile(n, rate)).copy()
    edge_cap = int(bi.sum()) + edge_slack
    if not _dvbs2_valid(bi, edge_cap, min_degree):
        # sanitize: keep the start's DEGREE PROFILE but spread each group's
        # edges round-robin over distinct row classes (the random legacy
        # draw can concentrate residues, violating the diversity rule)
        degs = np.maximum(bi.sum(axis=0), min_degree)
        bi = np.zeros_like(bi)
        for g in range(kb):
            for i in range(int(degs[g])):
                bi[(g * 7 + i * max(1, q // int(degs[g]))) % q, g] += 1
        # round-robin can still double a cell for degrees near q: spread
        # leftovers to empty rows
        for g in range(kb):
            while bi[:, g].max() > 2 or (bi[:, g] > 0).sum() < 3:
                l_hi = int(np.argmax(bi[:, g]))
                l_lo = int(np.argmin(bi[:, g]))
                bi[l_hi, g] -= 1
                bi[l_lo, g] += 1
    assert _dvbs2_valid(bi, edge_cap, min_degree), "unsatisfiable start"
    rate_f = k / n

    def thr_of(b, lo, hi):
        return threshold_ebn0(_dvbs2_protograph(b, q, kb), rate=rate_f,
                              punctured_cols=(), lo=lo, hi=hi, tol_db=tol_db)

    def converges(b, ebn0):
        pg = _dvbs2_protograph(b, q, kb)
        s = np.full(pg.shape[1], 8.0 * rate_f * 10.0 ** (ebn0 / 10.0))
        return pexit_run(pg, s).converged

    def resample_column(cand, g, deg):
        """Re-place column g with ``deg`` edges over distinct random rows
        (multiplicity 1 — maximally diverse)."""
        cand[:, g] = 0
        rows = rng.choice(q, size=min(int(deg), q), replace=False)
        cand[rows, g] = 1

    thr = thr_of(bi, -3.0, 10.0)
    for step in range(steps):
        cand = bi.copy()
        kind = rng.random()
        if kind < 0.25:
            # COLUMN move: shift one unit of degree between two columns
            # and re-place both — escapes local optima where single-unit
            # relocations are all rejected (the 64800 r1/2 plateau)
            g1, g2 = rng.choice(kb, size=2, replace=False)
            d1 = int(cand[:, g1].sum()) + 1
            d2 = int(cand[:, g2].sum()) - 1
            resample_column(cand, int(g1), d1)
            resample_column(cand, int(g2), d2)
        else:
            # sample the SOURCE from the nonzero cells (uniform over cells
            # is hopeless on large sparse profiles: 450 edges in a 90x90
            # grid hit a nonzero source 5% of the time and the search
            # stalls)
            nz_l, nz_g = np.nonzero(cand)
            e = int(rng.integers(0, len(nz_l)))
            l1, g1 = int(nz_l[e]), int(nz_g[e])
            l2, g2 = int(rng.integers(0, q)), int(rng.integers(0, kb))
            if kind < 0.7:                 # relocate one unit
                cand[l1, g1] -= 1
                cand[l2, g2] += 1
            elif kind < 0.85:              # add
                cand[l2, g2] += 1
            else:                          # drop
                cand[l1, g1] -= 1
        if not _dvbs2_valid(cand, edge_cap, min_degree):
            continue
        if converges(cand, thr - tol_db):
            bi = cand
            thr = thr_of(bi, thr - 2.0, thr)
            if log_every and (step % log_every == 0):
                print(f"[design] step {step}: threshold {thr:.3f} dB")
    return bi, thr


def realize_dvbs2_addresses(
    bi: np.ndarray, n: int, rate: str, seed: int = 0, draws: int = 24,
) -> Tuple[Tuple[int, ...], ...]:
    """Turn a designed multiplicity matrix into an EN 302 307-style address
    table: entry (l, g) with multiplicity c becomes c addresses
    ``a = l + q*t`` with distinct t in [0, 360) — drawn girth-aware with
    the same redraw-and-count loop as the synthetic default tables
    (:func:`.dvbs2.synthetic_address_table`)."""
    from .dvbs2 import _count_std_4cycles

    k, m, kb, q, z = _dvbs2_dims(n, rate)
    best, best_cycles = None, None
    for attempt in range(draws):
        rng = np.random.default_rng(302307 + n + 17 * seed + 7919 * attempt)
        addrs = []
        for g in range(kb):
            a_g = []
            for l in range(q):
                c = int(bi[l, g])
                if not c:
                    continue
                ts = rng.choice(z, size=c, replace=False)
                a_g.extend(int(l + q * t) for t in ts)
            addrs.append(tuple(a_g))
        cycles = _count_std_4cycles(addrs, k, m)
        if cycles == 0:
            return tuple(addrs)
        if best_cycles is None or cycles < best_cycles:
            best, best_cycles = tuple(addrs), cycles
    import warnings

    warnings.warn(
        f"designed dvbs2 n={n} r={rate}: no girth-6 realization in "
        f"{draws} draws; least-cyclic kept ({best_cycles} 4-cycles)",
        stacklevel=2,
    )
    return best
