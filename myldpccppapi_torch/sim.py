"""End-to-end Monte-Carlo simulation step on one device.

Counterpart of ``myldpccppapi_tpu/parallel/sim.py`` for one device: a step
simulates one batch — random info bits, encode (the code's matmul encoder,
or a family-specific ``encode_fn`` such as NR's triangular
back-substitution or DVB-S2's accumulator encode, ``ira_encode_fn``),
BPSK/AWGN or a higher-order constellation through complex AWGN and the
soft demapper (ops/modulation.py), optionally BICM-ID (ops/bicm_id.py),
decode, and exact integer error counts against the known truth.  With a
CRC (``cfg.crc``) or the DVB-S2 outer BCH (``cfg.outer`` or ``outer=``)
the step draws message bits and attaches the check before encoding, and
counts frames the check rejected apart from the undetected errors.
Randomness comes from a ``torch.Generator`` on the simulation's device, so
a step is reproducible from its seed (but draws other numbers than the
reference's threefry keys).  The multi-process campaign step,
``make_sharded_campaign_step``, is in ``parallel/sim.py``: it runs this
step on every rank, one generator per (mesh position, SNR point).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .ops.channel import channel_llr, sigma_from_snr_db
from .utils.config import DecoderConfig
from .utils.device import DEFAULT_DEVICE

__all__ = ["SimStats", "matmul_encode_fn", "make_decode_fn", "sim_step"]


class SimStats(NamedTuple):
    """Exact error statistics for one simulated batch (per SNR point), as
    0-d int64 tensors on the simulation's device.

    ``frame_errors`` counts every frame with info-bit errors; the
    detected/undetected split distinguishes errors the receiver KNOWS about
    (frame not accepted) from silently wrong accepted frames:
    ``detected = frame_errors - undetected_errors``.
    """

    frames: torch.Tensor        # codewords simulated
    frame_errors: torch.Tensor  # codewords with >=1 info-bit error
    bit_errors: torch.Tensor    # wrong info bits
    info_bits: torch.Tensor     # info bits simulated (frames * k_info)
    iterations: torch.Tensor    # total BP iterations used (sum over frames)
    unconverged: torch.Tensor   # frames that hit the iteration cap
    #: frames ACCEPTED (syndrome, and the CRC / BCH check when configured)
    #: yet wrong — the receiver cannot see these
    undetected_errors: torch.Tensor = 0
    #: converged frames an acceptance check rejected (0 without CRC/outer)
    crc_rejected: torch.Tensor = 0


def matmul_encode_fn(code, *, device=DEFAULT_DEVICE) -> Callable:
    """[B, k] info bits -> [B, n] codeword bits with the code's Encoder
    (float32 matmul mod 2 on ``device``, the card unless ``"cpu"``)."""
    from .codes.encoder import Encoder

    return Encoder(code, device=device)


def make_decode_fn(code, cfg: DecoderConfig, *, device=DEFAULT_DEVICE):
    """The implementation-dispatched decode callable: the Decoder facade,
    so simulations take the same dispatch as everything else (the CUDA
    kernels on the card, the torch path with ``device="cpu"``)."""
    from .decoder import Decoder

    return Decoder(code, cfg, device=device)


def sim_step(
    code,
    cfg: DecoderConfig,
    gen: torch.Generator,
    snr_db: float,
    batch: int,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    mod=None,
    demap: str = "maxlog",
    id_outer: int = 0,
    outer: "Optional[tuple]" = None,
) -> SimStats:
    """Simulate one batch at one SNR point on ``gen``'s device.

    Noise sigma follows the reference CLI convention sigma = 10^(-snr/20)
    (``Test.cpp:57``).  ``mod`` (an ``ops.modulation.Modulation``, default
    BPSK) selects the constellation: other symbols go through complex AWGN
    with per-component sigma (so ``snr_db`` stays Es/sigma^2 in dB, the
    BPSK path's convention, and n0 = 2 sigma^2), and the ``demap`` soft
    demapper ("maxlog" or "exact") gives the decoder's LLRs.  ``id_outer >
    0`` (not with BPSK) runs BICM-ID in place of the one-shot
    ``decode_fn``: that many demapper <-> decoder extrinsic exchanges after
    the first pass, with ``cfg``'s decoders on ``gen``'s device.

    When ``cfg.crc`` is set, random MESSAGE bits are drawn and the CRC is
    attached (TS 38.212 §5.1 code-block layout) before encoding, so the
    decoder's CRC-aided acceptance sees consistent frames; errors are still
    counted over the full information block (message + CRC field).
    ``outer=("bch", m, t)`` instead runs the EN 302 307 concatenated flow:
    the BCH parity (codes/bch.py) fills the last m*t' info bits and a frame
    is accepted when its syndrome converged and the BCH check of its
    decoded info bits passes, after the decode, as a DVB receiver does;
    with ``cfg.outer`` the decoder's own latch requires the BCH check.
    Frames the check rejected count into ``crc_rejected``.

    Draws, in order from ``gen``: the [batch, k] message bits
    (``torch.randint``; k = k_info less the CRC or BCH parity), then the
    standard normal noise (``torch.randn``): [batch, n] for BPSK, [batch,
    S, 2] (real, imaginary) for S symbols otherwise.  Not ported: the
    reference's ``llr_scale``, which no caller sets.
    """
    if cfg.crc and (outer is not None or cfg.outer):
        raise ValueError("choose either cfg.crc or an outer code, not both")
    if cfg.outer:
        if outer is not None and tuple(outer) != tuple(cfg.outer):
            raise ValueError(f"outer={outer} disagrees with cfg.outer={cfg.outer}")
        outer = cfg.outer
    bpsk = mod is None or mod.name == "bpsk"
    if bpsk and id_outer:
        raise ValueError("id_outer (BICM-ID) needs a non-BPSK mod")
    device = gen.device
    if encode_fn is None:
        encode_fn = matmul_encode_fn(code, device=device)
    if decode_fn is None:
        decode_fn = make_decode_fn(code, cfg, device=device)
    info_pos = torch.as_tensor(code.info_positions, device=device)
    kbits = len(info_pos)
    k_msg, attach, outer_check = kbits, None, None
    if cfg.crc:
        from .codes.crc import CRC_POLYS, crc_attach_fn

        k_msg = kbits - CRC_POLYS[cfg.crc][0]
        attach = crc_attach_fn(k_msg, cfg.crc)
    elif outer is not None:
        kind, m, t = outer
        if kind != "bch":
            raise ValueError(f"unknown outer code {kind!r}")
        from .codes.bch import bch_attach_fn, bch_check_fn, bch_matrix

        k_msg = kbits - bch_matrix(1, m, t).shape[1]
        attach = bch_attach_fn(k_msg, m, t)
        if not cfg.outer:
            # post-decode acceptance (the DVB receiver's flow)
            outer_check = bch_check_fn(k_msg, m, t)
    u = torch.randint(0, 2, (batch, k_msg), generator=gen, device=device,
                      dtype=torch.uint8)
    if attach is not None:
        u = attach(u)  # [B, kbits] message || CRC or BCH parity
    cw = encode_fn(u)  # [B, n] 0/1
    sigma = sigma_from_snr_db(snr_db).to(device)
    if bpsk:
        sym = 1.0 - 2.0 * cw.to(torch.float32)
        y = sym + sigma * torch.randn(sym.shape, generator=gen, device=device,
                                      dtype=torch.float32)
        res = decode_fn(channel_llr(y, sigma))
    else:
        from .ops.modulation import demap_llr, modulate

        sym = modulate(cw, mod)
        noise = torch.randn(sym.shape + (2,), generator=gen, device=device,
                            dtype=torch.float32)
        y = sym + sigma * torch.complex(noise[..., 0], noise[..., 1])
        n0 = 2.0 * sigma * sigma
        if id_outer:
            from .ops.bicm_id import make_bicm_id_receive

            rx = make_bicm_id_receive(code, cfg, mod, n_outer=id_outer,
                                      method=demap, device=device)
            res = rx(y, n0)
        else:
            res = decode_fn(demap_llr(y, n0, mod, demap))
    decoded_info = res.bits[:, info_pos]
    bit_err = (decoded_info != u).sum(dim=-1)  # [B]
    accepted = res.ok  # syndrome, and the CRC / BCH when in the decoder
    if outer_check is not None:
        accepted = accepted & outer_check(decoded_info)
    i64 = torch.int64
    return SimStats(
        frames=torch.tensor(batch, dtype=i64, device=device),
        frame_errors=(bit_err > 0).sum().to(i64),
        bit_errors=bit_err.sum().to(i64),
        info_bits=torch.tensor(batch * kbits, dtype=i64, device=device),
        iterations=res.iterations.sum().to(i64),
        unconverged=(~res.converged).sum().to(i64),
        undetected_errors=((bit_err > 0) & accepted).sum().to(i64),
        crc_rejected=(res.converged & ~accepted).sum().to(i64),
    )
