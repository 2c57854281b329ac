"""Protograph EXIT (PEXIT) analysis: decoding thresholds from base matrices.

Counterpart of ``myldpccppapi_tpu/codes/pexit.py``, a NumPy copy: given
any protograph (every :class:`~.qc.QCCode` carries one as its base
matrix), the iterative-decoding threshold on the binary-input AWGN channel
by tracking per-edge-type mutual information under the Gaussian
approximation (PEXIT, Liva & Chiani 2007, which generalizes
degree-distribution density evolution to protographs and handles punctured
variable nodes, the 5G NR case, exactly).

Thresholds depend on the protograph only: the lifting shifts move the
error floor, not the waterfall.  A protograph has tens of nodes, so one
threshold bisection costs milliseconds on the host: an offline design tool
(:mod:`.design`), not a device kernel.

J-function approximations: the two-segment polynomial/exponential fits of
J(sigma) = I(X; X*sigma^2/2 + sigma*N) and its inverse (ten Brink's EXIT
J; constants from Brannstrom, Rasmussen & Grant 2005), accurate to ~1e-3
in I.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "J", "J_inv", "protograph", "pexit_run", "threshold_ebn0",
    "threshold_sigma", "PexitResult",
]


# ---------------------------------------------------------------------------
# J function (mutual information of a consistent-Gaussian LLR message)
# ---------------------------------------------------------------------------

_A1, _B1, _C1 = -0.0421061, 0.209252, -0.00640081
_A2, _B2, _C2, _D2 = 0.00181491, -0.142675, -0.0822054, 0.0549608
_SIGMA_STAR = 1.6363

_AI1, _BI1, _CI1 = 1.09542, 0.214217, 2.33727
_AI2, _BI2, _CI2 = 0.706692, 0.386013, -1.75017
_I_STAR = 0.3646


def J(sigma):
    """Mutual information I(X; L) for L ~ N(x*sigma^2/2, sigma^2), x=+-1."""
    s = np.asarray(sigma, dtype=np.float64)
    low = _A1 * s**3 + _B1 * s**2 + _C1 * s
    high = 1.0 - np.exp(_A2 * s**3 + _B2 * s**2 + _C2 * s + _D2)
    out = np.where(s <= _SIGMA_STAR, low, high)
    return np.clip(np.where(s >= 10.0, 1.0, out), 0.0, 1.0)


def J_inv(i):
    """Inverse of :func:`J` (message sigma for a target mutual information)."""
    x = np.clip(np.asarray(i, dtype=np.float64), 0.0, 1.0 - 1e-12)
    low = _AI1 * x**2 + _BI1 * x + _CI1 * np.sqrt(x)
    high = -_AI2 * np.log(_BI2 * (1.0 - x)) - _CI2 * x
    return np.where(x <= _I_STAR, low, high)


# ---------------------------------------------------------------------------
# protograph extraction
# ---------------------------------------------------------------------------

def protograph(code) -> np.ndarray:
    """Edge-multiplicity matrix B[m_b, n_b] of a :class:`~.qc.QCCode`.

    Multi-edge positions (:attr:`~.qc.QCCode.extra_blocks`) count with their
    multiplicity — PEXIT handles parallel protograph edges natively.  Partial
    circulants (:attr:`~.qc.QCCode.masked_rows`, the DVB-S2 accumulator wrap)
    drop O(1/z) of one edge type and are counted as full edges — a
    vanishing-in-z approximation consistent with the asymptotic nature of
    density evolution.
    """
    if hasattr(code, "base"):
        b = (np.asarray(code.base) >= 0).astype(np.int64)
        if getattr(code, "extra_blocks", None):
            for (i, j, _s) in code.extra_blocks:
                b[i, j] += 1
        return b
    # block-protocol codes without a shift-exponent base matrix (RS-LDPC
    # XOR-group blocks): multiplicity count straight off the block list
    br, bc, _sh = code.blocks
    b = np.zeros((code.m_b, code.n_b), dtype=np.int64)
    np.add.at(b, (br, bc), 1)
    return b


def _punctured_cols(code) -> Tuple[int, ...]:
    pf = getattr(code, "punctured_front", 0)
    if not pf:
        return ()
    z = code.z
    if pf % z:
        raise ValueError("punctured_front must be a whole number of blocks")
    return tuple(range(pf // z))


# ---------------------------------------------------------------------------
# PEXIT recursion
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PexitResult:
    converged: bool
    iterations: int
    #: posterior mutual information per protograph variable node at exit
    i_app: np.ndarray
    #: Gaussian-approximation posterior bit error rate per variable node
    ber: np.ndarray


def _qfunc(x):
    """Gaussian tail Q(x) (via erfc; no scipy dependency)."""
    import math

    x = np.asarray(x, dtype=np.float64)
    return 0.5 * np.vectorize(math.erfc)(x / np.sqrt(2.0))


def pexit_run(
    b: np.ndarray,
    sigma_ch2: np.ndarray,
    max_iters: int = 2000,
    target_ber: float = 1e-5,
) -> PexitResult:
    """Run the PEXIT recursion for protograph ``b`` on an AWGN channel whose
    variable node j sees a channel LLR variance ``sigma_ch2[j]`` (0 for
    punctured nodes).

    Convergence criterion: the Gaussian-approximation posterior error rate
    ``Q(sqrt(v_app)/2)`` of EVERY variable node reaches ``target_ber``.  A
    strict I -> 1 criterion is NOT used: the J-function fits carry ~1e-3
    absolute MI error, so mutual-information targets tighter than that are
    below the approximation's resolution — protographs with degree-1
    variable nodes (the 5G NR extension columns) then plateau at
    I ~ 1 - 1e-4 despite a vanishing error rate, inflating thresholds by
    >1 dB.  The BER form is the criterion the PEXIT/protograph literature
    uses for exactly these ensembles.

    Per-edge-type state I_EV/I_EC on the nonzero positions of ``b``; the
    Gaussian-approximation updates add message variances (J_inv squared):

        VN j -> CN i:  all incident variances except one copy of edge (i,j),
                       plus the channel
        CN i -> VN j:  dual domain (1 - I), all incident except one (i,j)
    """
    b = np.asarray(b, dtype=np.int64)
    m_b, n_b = b.shape
    mask = b > 0
    # variance accumulators run over multiplicities; state is per edge TYPE
    i_ec = np.zeros((m_b, n_b))  # CN->VN mutual information per edge type
    sigma_ch2 = np.asarray(sigma_ch2, dtype=np.float64)
    prev_vapp = None

    for it in range(1, max_iters + 1):
        # --- VN -> CN ------------------------------------------------------
        v_ec = J_inv(i_ec) ** 2 * mask           # per-type message variance
        col_tot = (b * v_ec).sum(axis=0)         # [n_b] incl. multiplicity
        # exclude ONE copy of the receiving edge type; other parallel copies
        # of the same type still contribute (multi-edge semantics)
        v_ev = col_tot[None, :] - v_ec + sigma_ch2[None, :]
        i_ev = np.where(mask, J(np.sqrt(np.maximum(v_ev, 0.0))), 0.0)

        # --- CN -> VN (dual approximation) --------------------------------
        v_av = J_inv(1.0 - i_ev) ** 2 * mask
        row_tot = (b * v_av).sum(axis=1)
        v_out = row_tot[:, None] - v_av
        i_ec = np.where(mask, 1.0 - J(np.sqrt(np.maximum(v_out, 0.0))), 0.0)

        # --- posterior -----------------------------------------------------
        v_app = (b * (J_inv(i_ec) ** 2 * mask)).sum(axis=0) + sigma_ch2
        ber = _qfunc(np.sqrt(v_app) / 2.0)
        if (ber <= target_ber).all():
            return PexitResult(True, it, J(np.sqrt(v_app)), ber)
        # fixed-point stall: the recursion is monotone, so a vanishing
        # posterior-variance step means it will never reach the target
        if prev_vapp is not None and np.max(v_app - prev_vapp) < 1e-12:
            break
        prev_vapp = v_app
    return PexitResult(False, it, J(np.sqrt(v_app)), ber)


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------

def _channel_variances(b, rate, punctured, ebn0_db):
    n_b = b.shape[1]
    ebn0 = 10.0 ** (np.asarray(ebn0_db, dtype=np.float64) / 10.0)
    # BPSK AWGN: LLR variance 8 R Eb/N0 on transmitted nodes
    s = np.full(n_b, 8.0 * rate * ebn0)
    for j in punctured:
        s[j] = 0.0
    return s


def threshold_ebn0(
    code_or_b,
    rate: Optional[float] = None,
    punctured_cols: Optional[Sequence[int]] = None,
    lo: float = -2.0,
    hi: float = 10.0,
    tol_db: float = 0.01,
    max_iters: int = 1000,
) -> float:
    """Iterative-decoding threshold in Eb/N0 (dB) by bisection.

    Accepts a :class:`~.qc.QCCode` (rate/puncturing inferred, incl. the NR
    punctured systematic front and rate loss) or a raw protograph matrix with
    explicit ``rate``/``punctured_cols``.  Returns ``inf`` if even ``hi``
    does not converge.
    """
    if hasattr(code_or_b, "z"):
        code = code_or_b
        b = protograph(code)
        punctured = _punctured_cols(code)
        if rate is None:
            # Eb is per information bit over TRANSMITTED channel uses
            rate = code.k_info / (code.n - getattr(code, "punctured_front", 0))
    else:
        b = np.asarray(code_or_b)
        punctured = tuple(punctured_cols or ())
        if rate is None:
            rate = (b.shape[1] - b.shape[0]) / b.shape[1]

    def ok(ebn0_db):
        s = _channel_variances(b, rate, punctured, ebn0_db)
        return pexit_run(b, s, max_iters=max_iters).converged

    if not ok(hi):
        return float("inf")
    if ok(lo):
        return lo
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if ok(mid):
            hi = mid
        else:
            lo = mid
    return hi


def threshold_sigma(code_or_b, **kw) -> float:
    """Threshold as the maximal channel noise sigma (BPSK, Es=1): the
    conventional density-evolution sigma* = 1 / sqrt(2 R (Eb/N0)*)."""
    if hasattr(code_or_b, "z"):
        code = code_or_b
        rate = kw.pop("rate", None) or (
            code.k_info / (code.n - getattr(code, "punctured_front", 0))
        )
    else:
        b = np.asarray(code_or_b)
        rate = kw.pop("rate", None) or (b.shape[1] - b.shape[0]) / b.shape[1]
    thr = threshold_ebn0(code_or_b, rate=rate, **kw)
    if not np.isfinite(thr):
        return 0.0
    return float(1.0 / np.sqrt(2.0 * rate * 10.0 ** (thr / 10.0)))
