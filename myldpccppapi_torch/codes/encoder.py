"""Systematic LDPC encoding.

Counterpart of ``myldpccppapi_tpu/codes/encoder.py``.  The host-side
one-time precomputes are NumPy copies: the Richardson-Urbanke split H =
[A B T; C D E] with gap g = z, and, for a rank-deficient code that carries
an information set (``QCCode.info_cols``, codes/regular.py), the
information-set encoder of the GF(2) row reduction.  The batched runtime encode is one float32
``torch.matmul`` followed by ``% 2`` on the caller's device: CUDA has no
integer matmul, and every partial sum is an integer <= k < 2**24, so the
float32 product is exact.  With 0/1 inputs it stays exact under TF32 too
(inputs are representable, products exact, accumulation f32); the entry
points set ``torch.backends.cuda.matmul.allow_tf32 = False`` regardless.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .gf2 import gf2_inv, gf2_matmul, gf2_rref
from .qc import QCCode

__all__ = ["EncoderMatrices", "ru_precompute", "generic_precompute", "Encoder",
           "encode_numpy"]


@dataclasses.dataclass(frozen=True, eq=False)
class EncoderMatrices:
    """Dense GF(2) parity generator: parity = W @ info (bools, [m, k]).

    For non-systematic codes (``perm is not None``) the codeword is
    ``c[info_cols] = u, c[parity_cols] = W @ u`` — ``perm`` is the length-n
    position array ``concat([info_cols, parity_cols])`` such that
    ``c[perm] = concat([u, parity])``.
    """

    w: np.ndarray  # [n_parity, k] bool
    gap: int       # the RU gap g (z), or 0 if a fallback was used
    perm: "np.ndarray | None" = None  # [n] int64, None = systematic identity


def ru_precompute(code: QCCode) -> EncoderMatrices:
    """Richardson-Urbanke precompute with gap g = z.

    Splits H into [A B T; C D E] (T lower-triangular (m-g) x (m-g)), then
      p1 = phi^-1 (E T^-1 A + C) s          with phi = E T^-1 B + D
      p2 = T^-1 (A s + B p1)
    and stacks W = [W1; W2] so that parity = W @ s.  Falls back to the full
    inverse W = H_p^-1 H_s if the ALT split is singular for this code.
    """
    h = code.h_dense()
    m, n = h.shape
    k = n - m
    g = code.z
    try:
        a = h[: m - g, :k]
        b = h[: m - g, k : k + g]
        c = h[m - g :, :k]
        d = h[m - g :, k : k + g]
        t = h[: m - g, k + g :]
        e = h[m - g :, k + g :]
        inv_t = gf2_inv(t)
        e_inv_t = gf2_matmul(e, inv_t)
        phi = gf2_matmul(e_inv_t, b) ^ d
        w1 = gf2_matmul(gf2_inv(phi), gf2_matmul(e_inv_t, a) ^ c)  # [g, k]
        w2 = gf2_matmul(inv_t, a ^ gf2_matmul(b, w1))              # [m-g, k]
        w = np.concatenate([w1, w2], axis=0)
        gap = g
    except np.linalg.LinAlgError:
        # generic systematic fallback: p = H_p^-1 H_s s
        w = gf2_matmul(gf2_inv(h[:, k:]), h[:, :k])
        gap = 0
    # sanity: H @ [s; W s] = (H_s + H_p W) s must be 0 for all s
    residual = h[:, :k] ^ gf2_matmul(h[:, k:], w)
    if residual.any():
        raise AssertionError("encoder precompute failed: H @ G != 0")
    return EncoderMatrices(w=w, gap=gap)


def generic_precompute(h: np.ndarray) -> EncoderMatrices:
    """Information-set encoder for an arbitrary (even rank-deficient) H.

    Row-reduces H over GF(2); pivot columns become parity positions and the
    remaining ``n - rank`` columns carry information.  The row space, hence
    the codebook, is unchanged.  This covers code families whose parity
    block is singular (fully regular QC codes) where the RU split cannot
    apply.
    """
    h = np.asarray(h, dtype=np.bool_)
    n = h.shape[1]
    rref, pivot_cols = gf2_rref(h)
    info_cols = np.setdiff1d(np.arange(n, dtype=np.int64), pivot_cols)
    # row r of rref: c[pivot_r] = sum over free cols of rref[r, free] * c_free
    w = rref[:, info_cols]  # [rank, k_eff]
    perm = np.concatenate([info_cols, pivot_cols])
    return EncoderMatrices(w=w, gap=0, perm=perm)


def _scatter(perm: np.ndarray, stacked: np.ndarray) -> np.ndarray:
    """c[perm] = stacked along the last axis (numpy)."""
    c = np.empty_like(stacked)
    c[..., perm] = stacked
    return c


def encode_numpy(mats: EncoderMatrices, info_bits: np.ndarray) -> np.ndarray:
    """Reference-path numpy encode: info_bits [..., k] 0/1 -> [..., n]."""
    info_bits = np.asarray(info_bits)
    parity = (info_bits.astype(np.int64) @ mats.w.T.astype(np.int64)) % 2
    stacked = np.concatenate([info_bits, parity.astype(info_bits.dtype)], axis=-1)
    if mats.perm is None:
        return stacked
    return _scatter(mats.perm, stacked)


class Encoder:
    """Batched encoder: [B, k] info bits -> [B, n] codeword bits on
    ``device``, the card unless ``device="cpu"``: systematic (RU), or for a
    code with ``info_cols`` the information-set encoder, whose info bits
    land at ``code.info_positions``."""

    def __init__(self, code: QCCode, mats: EncoderMatrices | None = None,
                 *, device=DEFAULT_DEVICE):
        self.code = code
        if mats is None:
            if getattr(code, "info_cols", None) is not None:
                mats = generic_precompute(code.h_dense())
            else:
                mats = ru_precompute(code)
        self.mats = mats
        self.k = self.mats.w.shape[1]
        self.device = resolve_device(device)
        # [k, n_parity] 0/1 in float32 (see the module docstring)
        self._wt = torch.as_tensor(
            self.mats.w.T.astype(np.float32), device=self.device
        )
        self._inv_perm = None
        if self.mats.perm is not None:
            inv = np.empty(len(self.mats.perm), dtype=np.int64)
            inv[self.mats.perm] = np.arange(len(self.mats.perm))
            self._inv_perm = torch.as_tensor(inv, device=self.device)

    def __call__(self, info_bits: torch.Tensor) -> torch.Tensor:
        if info_bits.shape[-1] != self.k:
            raise ValueError(
                f"expected info length {self.k}, got {info_bits.shape[-1]}"
            )
        info_bits = info_bits.to(self.device)
        acc = torch.matmul(info_bits.to(torch.float32), self._wt)
        parity = torch.remainder(acc, 2.0).to(info_bits.dtype)
        stacked = torch.cat([info_bits, parity], dim=-1)
        if self._inv_perm is None:
            return stacked
        return stacked[..., self._inv_perm]
