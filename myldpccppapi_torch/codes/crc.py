"""GF(2) CRC attach/check as matrix products (TS 38.212 §5.1 polynomials).

Counterpart of ``myldpccppapi_tpu/codes/crc.py``.  With the all-zero
register initialization TS 38.212 specifies, the CRC of a message is
GF(2)-linear in the message bits: ``crc(u) = u @ C mod 2`` with ``C[k, L]``
precomputed by clocking the LFSR once per unit vector (NumPy copies of the
reference's host code, cached).  Attach and check run on the caller's
device as one float32 ``torch.matmul`` and ``% 2``: CUDA has no integer
matmul, and every partial sum of 0/1 products is an integer no larger
than k < 2**24, so the float32 product is exact (TF32 keeps 0/1 inputs
exact too).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "CRC_POLYS",
    "crc_numpy",
    "crc_matrix",
    "crc_attach_fn",
    "crc_check_fn",
]

#: Generator polynomials, MSB-first coefficient lists EXCLUDING the leading
#: x^L term (i.e. the low L coefficients), as integers.  TS 38.212
#: Section 5.1 names: 24A/24B attach to transport/code blocks, 24C to
#: polar-coded control, 16 to small transport blocks.
CRC_POLYS = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "24C": (24, 0xB2B117),
    "16": (16, 0x1021),
}


def _poly_bits(name: str) -> tuple[int, np.ndarray]:
    length, poly = CRC_POLYS[name]
    bits = np.array([(poly >> (length - 1 - i)) & 1 for i in range(length)],
                    dtype=np.uint8)
    return length, bits


def crc_numpy(u: np.ndarray, name: str = "24A") -> np.ndarray:
    """Bit-serial LFSR reference: ``u`` [..., k] 0/1 -> [..., L] CRC bits
    (MSB first), zero initialization, no final XOR (the 38.212 convention).
    Ground truth for :func:`crc_matrix`; use the matmul forms in hot paths.
    """
    length, taps = _poly_bits(name)
    u = np.asarray(u, dtype=np.uint8) & 1
    reg = np.zeros(u.shape[:-1] + (length,), dtype=np.uint8)
    for i in range(u.shape[-1]):
        fb = reg[..., 0] ^ u[..., i]
        reg = np.roll(reg, -1, axis=-1)
        reg[..., -1] = 0
        reg ^= fb[..., None] * taps
    return reg


def _clock_matrix(k: int, taps: np.ndarray) -> np.ndarray:
    """[k, L] uint8 parity matrix of the zero-init MSB-first LFSR with the
    given taps (L = len(taps)): row i is ``x^(L + k - 1 - i) mod g``, i.e.
    the parity of unit vector e_i.  Built bottom-up in O(k*L): the last
    row is ``x^L mod g = taps`` and each earlier row is the next one
    multiplied by x and reduced.  Shared by the CRCs here and the BCH
    generator (codes/bch.py)."""
    length = len(taps)
    rows = np.empty((k, length), dtype=np.uint8)
    r = taps.astype(np.uint8).copy()  # x^L mod g, MSB-first
    rows[k - 1] = r
    for i in range(k - 2, -1, -1):
        carry = r[0]
        r = np.roll(r, -1)
        r[-1] = 0
        if carry:
            r ^= taps
        rows[i] = r
    return rows


@functools.lru_cache(maxsize=None)
def crc_matrix(k: int, name: str = "24A") -> np.ndarray:
    """[k, L] uint8 matrix with ``crc(u) == (u @ C) % 2`` for any [., k] u.

    Row i is the CRC of the i-th unit vector; linearity over GF(2) (zero
    init, no final XOR) makes the superposition exact.
    """
    _, taps = _poly_bits(name)
    return _clock_matrix(k, taps)


class _Parity:
    """``u [..., k] 0/1 -> (u @ M) % 2`` as [..., L] float32 0/1 on u's
    device, M [k, L] a 0/1 matrix copied to each device once."""

    def __init__(self, mat: np.ndarray):
        if mat.shape[0] >= 1 << 24:
            raise ValueError("inner dimension too large for an exact f32 product")
        self._mat = mat.astype(np.float32)
        self._dev = {}

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        dev = u.device
        if dev not in self._dev:
            self._dev[dev] = torch.as_tensor(self._mat, device=dev)
        return torch.remainder(torch.matmul(u.to(torch.float32), self._dev[dev]), 2.0)


def _attach(mat: np.ndarray):
    """``u[B, k] -> [B, k + L]`` (message || parity of ``mat``), in u's
    dtype."""
    parity = _Parity(mat)

    def attach(u: torch.Tensor) -> torch.Tensor:
        return torch.cat([u, parity(u).to(u.dtype)], dim=-1)

    return attach


def _check(mat: np.ndarray):
    """``bits[..., k + L] -> bool[...]``: the received parity field equals
    the parity of the message part."""
    k, length = mat.shape
    parity = _Parity(mat)

    def check(bits: torch.Tensor) -> torch.Tensor:
        rx = bits[..., k:k + length].to(torch.float32)
        return (parity(bits[..., :k]) == rx).all(dim=-1)

    return check


def crc_attach_fn(k: int, name: str = "24A"):
    """``u[B, k] -> [B, k + L]`` (message || CRC), the 38.212 code-block
    attachment, on u's device and in u's dtype."""
    return _attach(crc_matrix(k, name))


def crc_check_fn(k: int, name: str = "24A"):
    """``bits[B, k + L] -> bool[B]`` (True = CRC passes): the CRC of the
    message part recomputed and compared with the received CRC field; a
    CRC-aided acceptance test beside the LDPC syndrome."""
    return _check(crc_matrix(k, name))
