"""PEXIT-designed synthetic NR base-graph supports (generated data).

NumPy copy of ``myldpccppapi_tpu/codes/nr_designed.py``.

Produced by the reference's ``design.optimize_nr_support`` (greedy threshold descent
under the TS 38.212 structural constraints) and frozen here by
``benchmarks/gen_designed_supports.py``; thresholds below are Eb/N0 (dB) at
the mother rate with the 2Z front puncture (codes/pexit.py).  These replace
the profile-recall synthetic supports where measurement confirmed the
design gain (BENCH_NOTES round 4); the bit-true standard tables remain a
drop-in via ``nr_code(table=parse_bg_table(...))`` exactly as before
(PROVENANCE.md).

Format: ``DESIGNED_SUPPORT[bg]`` is a tuple of per-row tuples of column
indices over the mutable region (systematic + core-parity columns); the
core staircase and identity extension columns are implied by the
structure and added by ``nr_base_graph``.
"""
import numpy as np

__all__ = ["DESIGNED_SUPPORT", "DESIGNED_THRESHOLD_DB", "designed_support"]

DESIGNED_SUPPORT = {
    2: (
        (0, 1, 3, 4, 5, 6, 8, 9, 10),
        (0, 1, 2, 3, 4, 7, 8, 9, 10, 11),
        (2, 3, 5, 6, 8, 9, 10, 11, 12),
        (0, 1, 2, 4, 5, 6, 7, 9, 12, 13),
        (0, 2, 5, 7, 12, 14),
        (1, 2, 6, 13, 15),
        (0, 8, 12, 16),
        (7, 8, 12, 17),
        (0, 5, 7, 8, 18),
        (1, 7, 8, 19),
        (0, 2, 5, 7, 9, 20),
        (1, 2, 5, 7, 21),
        (0, 2, 7, 11, 22),
        (1, 2, 9, 23),
        (0, 2, 11, 24),
        (6, 7, 9, 12, 13, 25),
        (2, 6, 7, 26),
        (1, 3, 5, 6, 10, 13, 27),
        (0, 2, 7, 12, 13, 28),
        (1, 6, 8, 29),
        (2, 5, 9, 30),
        (2, 7, 9, 31),
        (0, 2, 3, 13, 32),
        (1, 2, 7, 33),
        (0, 2, 3, 5, 34),
        (1, 2, 8, 35),
        (0, 2, 8, 36),
        (2, 7, 8, 37),
        (0, 2, 7, 8, 38),
        (7, 8, 12, 39),
        (0, 4, 7, 12, 13, 40),
        (1, 6, 7, 9, 12, 41),
        (5, 7, 8, 42),
        (1, 6, 8, 12, 43),
        (0, 7, 12, 44),
        (1, 4, 5, 45),
        (0, 2, 12, 46),
        (1, 5, 6, 7, 47),
        (0, 7, 9, 48),
        (6, 7, 8, 9, 49),
        (0, 3, 5, 7, 12, 50),
        (2, 7, 9, 51),
    ),
}

DESIGNED_THRESHOLD_DB = {2: -0.715}

_SHAPES = {2: (42, 52)}


def designed_support(bg: int) -> np.ndarray:
    """Boolean [m_b, n_b] support; raises KeyError for undesigned graphs."""
    rows = DESIGNED_SUPPORT[bg]
    m_b, n_b = _SHAPES[bg]
    b = np.zeros((m_b, n_b), dtype=bool)
    for i, cols in enumerate(rows):
        b[i, list(cols)] = True
    return b
