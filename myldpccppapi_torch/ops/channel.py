"""BPSK modulation, AWGN channel, and LLR computation.

Counterpart of ``myldpccppapi_tpu/ops/channel.py`` (the reference C++
library's self-test channel, ``Coder::test``, ``MyLdpc.cpp:1061-1078``:
bit 1 -> -1.0, bit 0 -> +1.0, plus Gaussian noise of standard deviation
sigma).  Noise comes from an explicit ``torch.Generator``, which must live
on the device of the symbols; it gives other numbers than JAX's threefry
for the same seed.

LLR conventions: **positive LLR => bit 0**.  The BPSK/AWGN LLR is
``2 y / sigma^2`` (the default ``llr_scale``); ``llr_scale = 1.0`` feeds the
raw channel value, as the reference's min-sum decoders do.
"""
from __future__ import annotations

import torch

__all__ = [
    "sigma_from_snr_db",
    "snr_db_from_ebn0_db",
    "bpsk_modulate",
    "awgn",
    "channel_llr",
    "transmit",
]


#: log10(e) as the reference's f32 log10 multiplies by it
_LOG10_E = 0.4342944920063019


def sigma_from_snr_db(snr_db) -> torch.Tensor:
    """Noise sigma from SNR in dB (float32), sigma = 10^(-snr/20), i.e.
    Es/N0 with Es = 1 (``Test.cpp:57``)."""
    return 10.0 ** (-torch.as_tensor(snr_db, dtype=torch.float32) / 20.0)


def snr_db_from_ebn0_db(ebn0_db, rate: float, bits_per_symbol: int = 1) -> torch.Tensor:
    """Eb/N0 (dB) -> the Es/N0-style SNR above (float32), for a code rate
    and modulation order: Es = rate * bits_per_symbol * Eb.  The log10 is
    the reference's f32 ``log(x) * 0.4342944920063019``; its f32 ``log`` is
    XLA's, which may differ from torch's in the last place."""
    log10 = torch.log(torch.tensor(rate * bits_per_symbol, dtype=torch.float32)) * _LOG10_E
    return torch.as_tensor(ebn0_db, dtype=torch.float32) + 10.0 * log10


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """0 -> +1.0, 1 -> -1.0 (float32)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def awgn(gen: torch.Generator, symbols: torch.Tensor, sigma) -> torch.Tensor:
    noise = torch.randn(symbols.shape, generator=gen, dtype=symbols.dtype,
                        device=symbols.device)
    return symbols + sigma * noise


def channel_llr(received: torch.Tensor, sigma, llr_scale=None) -> torch.Tensor:
    """LLR(bit=0 vs 1) of the received symbols.  Default: 2 y / sigma^2."""
    if llr_scale is None:
        llr_scale = 2.0 / (torch.as_tensor(sigma, dtype=torch.float32) ** 2)
    return received * llr_scale


def transmit(gen: torch.Generator, bits: torch.Tensor, snr_db, llr_scale=None):
    """bits -> BPSK -> AWGN -> LLRs.  Returns (llr, sigma)."""
    sigma = sigma_from_snr_db(snr_db)
    y = awgn(gen, bpsk_modulate(bits), sigma)
    return channel_llr(y, sigma, llr_scale), sigma
