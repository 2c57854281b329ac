"""Outer BCH code for the DVB-S2 FEC frame (EN 302 307 §5.3.1 layout).

Counterpart of ``myldpccppapi_tpu/codes/bch.py``: the GF(2^m) arithmetic,
the generator, the DVB-S2 parameters, the parity matrix, the syndromes and
the Berlekamp–Massey + Chien corrector are NumPy copies of the reference's
host code.  DVB-S2 concatenates an outer t-error-correcting BCH code with
the inner LDPC (t in {8, 10, 12} over GF(2^16) for normal frames, t = 12
over GF(2^14) for short ones); the BCH plays the role CRC24B plays in NR,
residual-error detection after the inner decode.

* **Attach and detect on the device**: with zero register initialization
  the BCH parity is GF(2)-linear in the message, so attach and check are
  the CRC's float32 bit-matrix products (codes/crc.py) with one [k, m*t]
  matrix: :func:`bch_attach_fn` / :func:`bch_check_fn`.
* **Correct on the host**: syndromes, Berlekamp–Massey and the Chien search
  (:func:`bch_correct`) in NumPy, for the rare frames with small residual
  error patterns.

Field and polynomial provenance follow the reference: the field is
generated by the lexicographically smallest primitive polynomial of the
required degree (computed), and g(x) is the lcm of the minimal polynomials
of alpha^1..alpha^2t, so the constructions are bit-identical to the
reference's.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from .crc import _attach, _check, _clock_matrix

__all__ = [
    "smallest_primitive_poly",
    "bch_generator",
    "bch_params_dvbs2",
    "bch_matrix",
    "bch_attach_fn",
    "bch_check_fn",
    "bch_syndromes",
    "bch_correct",
]


# -- GF(2^m) arithmetic on Python ints (bit i = coefficient of x^i) ---------

def _gf_mul(a: int, b: int, poly: int, m: int) -> int:
    """Carry-less multiply mod the degree-m polynomial ``poly``."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> m:
            a ^= poly
    return r


def _gf_pow(a: int, e: int, poly: int, m: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf_mul(r, a, poly, m)
        a = _gf_mul(a, a, poly, m)
        e >>= 1
    return r


def _gf_inv(a: int, poly: int, m: int) -> int:
    return _gf_pow(a, (1 << m) - 2, poly, m)


def _is_primitive(poly: int, m: int) -> bool:
    """x generates the full multiplicative group mod poly (order 2^m - 1)."""
    order = (1 << m) - 1
    # must not hit 1 at any proper divisor of the group order
    if _gf_pow(2, order, poly, m) != 1:
        return False
    d = 2
    n = order
    prime_factors = set()
    while d * d <= n:
        while n % d == 0:
            prime_factors.add(d)
            n //= d
        d += 1
    if n > 1:
        prime_factors.add(n)
    return all(_gf_pow(2, order // p, poly, m) != 1 for p in prime_factors)


@functools.lru_cache(maxsize=None)
def smallest_primitive_poly(m: int) -> int:
    """Lexicographically smallest degree-m primitive polynomial over GF(2)
    (deterministic, computed — see module docstring on provenance)."""
    for low in range(1, 1 << m, 2):  # constant term must be 1
        poly = (1 << m) | low
        if _is_primitive(poly, m):
            return poly
    raise RuntimeError(f"no primitive polynomial of degree {m}")  # unreachable


def _poly_mul(a: int, b: int) -> int:
    """GF(2)[x] product of polynomials-as-ints."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
    return r


@functools.lru_cache(maxsize=None)
def _minimal_poly(i: int, poly: int, m: int) -> int:
    """Minimal polynomial of alpha^i over GF(2): prod over the conjugacy
    class {i*2^j} of (x - alpha^c), expanded via GF(2^m) arithmetic."""
    order = (1 << m) - 1
    # conjugacy class
    cls, c = [], i % order
    while c not in cls:
        cls.append(c)
        c = (c * 2) % order
    # expand prod (x + alpha^c): coeffs[d] = coefficient of x^d
    coeffs = [1]
    for c in cls:
        root = _gf_pow(2, c, poly, m)
        nxt = [0] * (len(coeffs) + 1)
        for d, a in enumerate(coeffs):
            nxt[d] ^= _gf_mul(a, root, poly, m)   # multiply by root
            nxt[d + 1] ^= a                        # shift (times x)
        coeffs = nxt
    # all coefficients must collapse to GF(2)
    out = 0
    for d, a in enumerate(coeffs):
        assert a in (0, 1), "minimal polynomial left the base field"
        out |= a << d
    return out


@functools.lru_cache(maxsize=None)
def bch_generator(m: int, t: int, primitive_poly: "int | None" = None) -> int:
    """g(x) = lcm of minimal polys of alpha^1..alpha^2t (degree <= m*t)."""
    poly = primitive_poly or smallest_primitive_poly(m)
    g = 1
    seen = set()
    for i in range(1, 2 * t + 1):
        mp = _minimal_poly(i, poly, m)
        if mp not in seen:
            seen.add(mp)
            g = _poly_mul(g, mp)
    return g


#: EN 302 307 Table 5a/5b BCH layout: (n, rate) -> (t, n_bch - k_bch).
#: n_bch = k_ldpc always; normal frames use GF(2^16), short GF(2^14).
_DVBS2_T = {
    (64800, "1/4"): 12, (64800, "1/3"): 12, (64800, "2/5"): 12,
    (64800, "1/2"): 12, (64800, "3/5"): 12, (64800, "2/3"): 10,
    (64800, "3/4"): 12, (64800, "4/5"): 12, (64800, "5/6"): 10,
    (64800, "8/9"): 8, (64800, "9/10"): 8,
}


def bch_params_dvbs2(n: int, rate: str) -> Tuple[int, int, int]:
    """(m, t, parity_bits) for the outer BCH of a DVB-S2 (n, rate) frame.
    Short frames (n=16200) all use t=12 over GF(2^14) (Table 5b)."""
    if n == 16200:
        m, t = 14, 12
    else:
        m, t = 16, _DVBS2_T[(n, rate)]
    g = bch_generator(m, t)
    return m, t, g.bit_length() - 1


@functools.lru_cache(maxsize=None)
def bch_matrix(k: int, m: int, t: int) -> np.ndarray:
    """[k, deg(g)] uint8 with ``parity(u) == (u @ B) % 2``: systematic BCH
    parity is remainder(u(x)·x^deg(g), g(x)), GF(2)-linear in u.  Uses the
    shared O(k*L) shift-reduce construction (codes/crc.py)."""
    g = bch_generator(m, t)
    length = g.bit_length() - 1
    if k + length > (1 << m) - 1:
        raise ValueError(
            f"BCH over GF(2^{m}): k + parity = {k + length} exceeds the "
            f"maximum (shortened) code length {(1 << m) - 1}"
        )
    taps = np.array([(g >> (length - 1 - i)) & 1 for i in range(length)],
                    dtype=np.uint8)
    return _clock_matrix(k, taps)


def bch_attach_fn(k: int, m: int, t: int):
    """``u[B, k] -> [B, k + m*t']`` (message || BCH parity), the EN 302 307
    BCHFEC layout, on u's device and in u's dtype."""
    return _attach(bch_matrix(k, m, t))


def bch_check_fn(k: int, m: int, t: int):
    """``bits[B, k + P] -> bool[B]`` (True = BCH parity consistent: no
    detected residual errors)."""
    return _check(bch_matrix(k, m, t))


# -- host-side correction (numpy) -------------------------------------------

@functools.lru_cache(maxsize=None)
def _log_tables(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(alog, log): alog[i] = alpha^i (i < 2^m - 1), log[alog[i]] = i."""
    poly = smallest_primitive_poly(m)
    order = (1 << m) - 1
    alog = np.empty(order, dtype=np.int64)
    v = 1
    for i in range(order):
        alog[i] = v
        v = _gf_mul(v, 2, poly, m)
    log = np.zeros(1 << m, dtype=np.int64)
    log[alog] = np.arange(order)
    return alog, log


def bch_syndromes(bits: np.ndarray, m: int, t: int) -> np.ndarray:
    """S_j = r(alpha^j) for j = 1..2t.  ``bits`` [..., n] with the module's
    polynomial convention: bit 0 is the HIGHEST-degree coefficient (first
    transmitted), matching the attach layout message||parity.  Vectorized
    over positions via log/antilog tables."""
    alog, _ = _log_tables(m)
    order = (1 << m) - 1
    bits = np.asarray(bits, dtype=np.uint8) & 1
    n = bits.shape[-1]
    if n > order:
        raise ValueError(
            f"BCH over GF(2^{m}) supports n <= {order} (shortened); got {n}"
        )
    flat = bits.reshape(-1, n)
    out = np.zeros((flat.shape[0], 2 * t), dtype=np.int64)
    exp0 = (n - 1 - np.arange(n)).astype(np.int64)  # bit i -> exponent of x
    for r in range(flat.shape[0]):
        nz = exp0[flat[r].astype(bool)]
        if nz.size == 0:
            continue
        for j in range(1, 2 * t + 1):
            out[r, j - 1] = np.bitwise_xor.reduce(alog[(j * nz) % order])
    return out.reshape(*bits.shape[:-1], 2 * t)


def bch_correct(bits: np.ndarray, m: int, t: int):
    """Berlekamp–Massey + Chien search: correct up to t bit errors in each
    [..., n] word.  Returns (corrected bits, ok bool[...]) where ok=False
    marks words whose error locator failed (more than t errors)."""
    poly = smallest_primitive_poly(m)
    order = (1 << m) - 1
    bits = (np.asarray(bits, dtype=np.uint8) & 1).copy()
    n = bits.shape[-1]
    flat = bits.reshape(-1, n)
    ok = np.ones(flat.shape[0], dtype=bool)
    syn = bch_syndromes(flat, m, t).reshape(-1, 2 * t)
    for r in range(flat.shape[0]):
        s = [int(x) for x in syn[r]]
        if not any(s):
            continue
        # Berlekamp–Massey over GF(2^m)
        c_poly, b_poly = [1], [1]
        L, mm, bb = 0, 1, 1
        for i in range(2 * t):
            d = s[i]
            for j in range(1, L + 1):
                if j < len(c_poly):
                    d ^= _gf_mul(c_poly[j], s[i - j], poly, m)
            if d == 0:
                mm += 1
            elif 2 * L <= i:
                tmp = c_poly[:]
                coef = _gf_mul(d, _gf_inv(bb, poly, m), poly, m)
                shifted = [0] * mm + [_gf_mul(coef, x, poly, m) for x in b_poly]
                c_poly = [
                    (c_poly[j] if j < len(c_poly) else 0)
                    ^ (shifted[j] if j < len(shifted) else 0)
                    for j in range(max(len(c_poly), len(shifted)))
                ]
                L, b_poly, bb, mm = i + 1 - L, tmp, d, 1
            else:
                coef = _gf_mul(d, _gf_inv(bb, poly, m), poly, m)
                shifted = [0] * mm + [_gf_mul(coef, x, poly, m) for x in b_poly]
                c_poly = [
                    (c_poly[j] if j < len(c_poly) else 0)
                    ^ (shifted[j] if j < len(shifted) else 0)
                    for j in range(max(len(c_poly), len(shifted)))
                ]
                mm += 1
        if L > t:
            ok[r] = False
            continue
        # Chien search, vectorized: bit i sits at exponent e = n-1-i; the
        # locator has a root at alpha^-e <=> error at position i.  Evaluate
        # Lambda(alpha^-e) = XOR_d alog[(log c_d + d*(-e)) % order] for all
        # e at once via the log/antilog tables.
        alog, logt = _log_tables(m)
        e_all = (n - 1 - np.arange(n)).astype(np.int64)
        acc = np.zeros(n, dtype=np.int64)
        for d, coef in enumerate(c_poly):
            if coef == 0:
                continue
            acc ^= alog[(int(logt[coef]) + d * (-e_all)) % order]
        found = np.nonzero(acc == 0)[0]
        if len(found) != L:
            ok[r] = False
            continue
        flat[r, found] ^= 1
    return flat.reshape(bits.shape), ok.reshape(bits.shape[:-1])
