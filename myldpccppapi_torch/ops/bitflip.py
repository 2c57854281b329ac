"""Gradient-descent bit-flipping (GDBF) decoding: the high-throughput /
low-complexity tier below BP.

Counterpart of ``myldpccppapi_tpu/ops/bitflip.py``: multi-threshold GDBF
(Wadayama et al. 2010) with the noisy-GDBF perturbation (Sundararajan et
al. 2014) on the circulant / xor block structure of the BP decoders.  The
state is one bipolar decision vector x in {+-1}^n, no per-edge messages:

    objective  f(x) = sum_v x_v y_v + sum_m prod_{v in N(m)} x_v
    inversion  Delta_v = x_v y_v + sum_{m in M(v)} c_m,   c_m = check prod
    flip       every v with Delta_v + noise < theta

Torch ops on the LLRs' device, in the reference's order: the channel term
scaled by the per-frame mean |y| over the blocks, the check products and
their votes accumulated in (layer, entry) order (masked rows of a partial
circulant vote nothing and count as +1 in the product), a failure flag
per layer, the latch of converged frames (bits, iteration count), flips
frozen for converged frames, then the perturbation ``noise_scale *
N(0, 1)`` from the caller's generator.  The early-exit test is one host
read of ``done.all()`` per iteration, as in ops/bp.py.  The reference has
no Pallas kernel for GDBF (XLA ops), so neither has the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .bp import DecodeResult, _aligners, _from_blocks, _layers, _masks, _to_blocks

__all__ = ["GDBFConfig", "decode_gdbf"]


@dataclasses.dataclass(frozen=True)
class GDBFConfig:
    """Multi-flip noisy-GDBF configuration (the reference's fields and
    defaults)."""

    max_iters: int = 100
    #: flip threshold: bits with inversion metric below this flip.  0 is
    #: the plain multi-flip rule; small negative values flip fewer bits
    #: per iteration (more conservative, less oscillation).
    theta: float = 0.0
    #: stddev of the per-bit perturbation, relative to the mean channel
    #: magnitude.  0 disables noisy-GDBF (deterministic, can stall on
    #: oscillating patterns).
    noise_scale: float = 0.6
    #: weight of the channel term against the (unit-weight) check votes;
    #: y is divided by its per-frame mean magnitude so one flipped check
    #: outvotes an average-confidence channel bit.
    channel_weight: float = 1.0
    early_exit: bool = True


def decode_gdbf(code, cfg: GDBFConfig, llr: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> DecodeResult:
    """Decode [B, n] channel LLRs (positive => bit 0) with noisy GDBF on
    ``llr``'s device.

    ``generator``: the perturbation's ``torch.Generator`` on that device;
    without one, a generator seeded with 0 (the counterpart of the
    reference's fixed key), so each such call draws the same noise.  The
    reference's threefry noise and torch's differ: with noise the two
    agree statistically, at ``noise_scale=0`` bit for bit."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    dev = llr.device
    layers = _layers(code)
    row_align, col_align = _aligners(code)
    masks_t = _masks(code, dev)
    if generator is None and cfg.noise_scale:
        generator = torch.Generator(device=dev).manual_seed(0)

    y = _to_blocks(llr.to(torch.float32), n_b, z)  # [n_b, z, B]
    # scale-free channel term: mean |y| -> 1 per frame
    norm = y.abs().mean(dim=(0, 1), keepdim=True)
    y = cfg.channel_weight * y / torch.clamp(norm, min=1e-30)
    x = torch.where(y >= 0, 1.0, -1.0)  # bipolar hard decision (+1 = bit 0)

    bits_out = torch.zeros((n_b, z, bsz), dtype=torch.bool, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        votes = x * y  # the x_v y_v term
        fail = None
        for (_, entries) in layers:
            prod = None
            for (e, j, s, _) in entries:
                xa = row_align(x[j], s)
                if e in masks_t:
                    xa = torch.where(masks_t[e], xa, 1.0)
                prod = xa if prod is None else prod * xa
            layer_fail = (prod < 0).any(dim=0)  # [B]
            fail = layer_fail if fail is None else fail | layer_fail
            for (e, j, s, _) in entries:
                contrib = prod
                if e in masks_t:
                    contrib = torch.where(masks_t[e], contrib, 0.0)
                votes[j] += col_align(contrib, s)
        bits = x < 0
        keep = done.view(1, 1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        iters = torch.where(done, iters, t + 1)
        done = done | ~fail
        # flip: inversion metric below theta (+ perturbation); frozen for
        # converged frames
        delta = votes
        if cfg.noise_scale:
            delta = delta + cfg.noise_scale * torch.randn(
                votes.shape, generator=generator, device=dev)
        flip = (delta < cfg.theta) & ~done.view(1, 1, -1)
        x = torch.where(flip, -x, x)
        t += 1
    return DecodeResult(
        bits=_from_blocks(bits_out).to(torch.uint8),
        converged=done,
        iterations=iters,
        total_iters=torch.tensor(t, dtype=torch.int32, device=dev),
    )
