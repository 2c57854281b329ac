"""Bit <-> byte packing, LSB-first within each byte.

Counterpart of ``myldpccppapi_tpu/ops/packing.py``: bit index b of byte i
is bit (8*i + b) of the stream, LSB first (the reference C++ library's
encode unpack at ``MyLdpc.cpp:643-646`` and decode pack kernel ``toChar``
at ``decodeCL.c:188-199``).  :func:`unpack_bits` / :func:`pack_bits` work on
tensors on any device, the ``_np`` pair on NumPy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "unpack_bits_np", "pack_bits_np"]


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> uint8 bits [..., L*8], LSB-first."""
    data = data.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits [..., L*8] -> uint8 [..., L], LSB-first."""
    if bits.shape[-1] % 8 != 0:
        raise ValueError("bit length must be a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits_np(data: np.ndarray) -> np.ndarray:
    """uint8 [..., L] -> uint8 bits [..., L*8], LSB-first."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data[..., :, None], axis=-1, bitorder="little")
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """0/1 bits [..., L*8] -> uint8 [..., L], LSB-first."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.shape[-1] % 8 != 0:
        raise ValueError("bit length must be a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    return np.packbits(b, axis=-1, bitorder="little")[..., 0]
