"""Layered belief-propagation decoder for QC-LDPC codes, plain torch path.

Counterpart of the layered part of ``myldpccppapi_tpu/ops/bp.py`` and the
**plain version** of the CUDA kernels in ``csrc/bp_layered.cu`` and
``csrc/bp_long.cu`` (whose lazy-syndrome mode it serves through the private
``_decode_layered(..., lazy=True)``): the same function written as
ordinary tensor ops, run on any device.  The f32 operation order is the
reference jnp path's, so the results are bit-exact with it
(tests/test_torch_decode.py) and with the kernels (``chip_smoke.py``):

* the check update copies the jnp form: argmin, m2 over the rest, the clamp
  of ``mag`` to 1e30, then beta, then alpha;
* the posterior is updated by ``P += col_align(r_new - r_old)`` per entry
  in row-major block order, never rebuilt from the channel plus R;
* converged codewords latch their bits and iteration count while the batch
  continues; the early-exit test is one host read of ``done.all()`` per
  iteration (the reference's ``lax.while_loop`` condition).

Tensor layout: LLR/posterior ``[n_b, z, B]``; per-edge messages
``[E_b, z, B]`` row-aligned (see codes/qc.py for the alignment convention).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig

__all__ = ["DecodeResult", "decode_layered", "layer_weights"]

_Q_INF = 1e30  # masked-row q magnitude: the min-sum identity


class DecodeResult(NamedTuple):
    """Decoded hard bits plus convergence statistics."""

    bits: torch.Tensor        # [B, n] uint8 hard decisions (full codeword)
    converged: torch.Tensor   # [B] bool: syndrome == 0
    iterations: torch.Tensor  # [B] int32: iterations used per codeword
    total_iters: torch.Tensor  # 0-d int32: batch iterations executed

    @property
    def ok(self) -> torch.Tensor:
        """Frame acceptance: the syndrome check (no CRC in the port yet)."""
        return self.converged


def _to_blocks(llr: torch.Tensor, n_b: int, z: int) -> torch.Tensor:
    """[B, n] -> a new [n_b, z, B] tensor (never a view of ``llr``: the
    decoder updates it in place)."""
    out = llr.new_empty((n_b, z, llr.shape[0]))
    return out.copy_(llr.t().reshape(n_b, z, llr.shape[0]))


def _from_blocks(x: torch.Tensor) -> torch.Tensor:
    """[n_b, z, B] -> [B, n]."""
    n_b, z, b = x.shape
    return x.reshape(n_b * z, b).t().contiguous()


def _row_align(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Column-aligned [z, B] tile -> row-aligned (value at check row r is the
    variable (r + shift) % z)."""
    return torch.roll(x, -shift, dims=0) if shift else x


def _col_align(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, dims=0) if shift else x


def _check_update_minsum(qs: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Min-sum check-node update with self-exclusion over axis 0 (the jnp
    form of ``myldpccppapi_tpu/ops/bp.py::_check_update_minsum``): the
    excluding-self min is m2 where this edge is the argmin, else m1; the
    excluding-self sign is the total sign parity XOR the edge's own sign."""
    a = qs.abs()
    neg = (qs < 0).to(torch.int32)
    m1, am = torch.min(a, dim=0)
    idx = torch.arange(qs.shape[0], device=qs.device).view(-1, 1, 1)
    is_min = idx == am.unsqueeze(0)
    m2 = torch.where(is_min, torch.inf, a).amin(dim=0)
    mag = torch.where(is_min, m2.unsqueeze(0), m1.unsqueeze(0))
    # weight-1 rows (excluding-self min over nothing) would give mag=inf
    mag = torch.clamp(mag, max=_Q_INF)
    if beta:
        mag = torch.clamp(mag - beta, min=0.0)
    if alpha != 1.0:
        mag = alpha * mag
    sign_excl = (neg.sum(dim=0) & 1).unsqueeze(0) ^ neg
    return torch.where(sign_excl == 1, -mag, mag)


def layer_weights(normalization, offset, n_layers: int):
    """Per-layer (alphas, betas) float tuples of a DecoderConfig weight
    schedule: a scalar applies to every layer, a flat tuple gives one value
    per base row.  Per-iteration schedules are refused by DecoderConfig."""

    def per_layer(w):
        if isinstance(w, (int, float)):
            return (float(w),) * n_layers
        if len(w) != n_layers:
            raise ValueError(
                f"per-layer weights need one value per base row "
                f"({n_layers}), got {len(w)}"
            )
        return tuple(float(x) for x in w)

    return per_layer(normalization), per_layer(offset)


def _layers(code: QCCode):
    """Static per-layer structure: list of (p0, entries) where each entry is
    (e, j, shift, live_rows) and ``live_rows`` is a bool[z] numpy mask of
    real check rows (None = full circulant — the common case)."""
    br, bc, sh = code.blocks
    masks = code.block_row_masks
    ptr = code.layer_ptr
    out = []
    for i in range(code.m_b):
        p0, p1 = int(ptr[i]), int(ptr[i + 1])
        out.append((p0, [(e, int(bc[e]), int(sh[e]), masks[e])
                         for e in range(p0, p1)]))
    return out


def _syndrome_fail(bits_blocks: torch.Tensor, layers, masks_t) -> torch.Tensor:
    """[n_b, z, B] hard bits (bool) -> [B] bool, True where any check fails."""
    fail = None
    for (_, entries) in layers:
        par = None
        for (e, j, s, _) in entries:
            contrib = _row_align(bits_blocks[j], s).to(torch.int32)
            if e in masks_t:
                contrib = torch.where(masks_t[e], contrib, 0)
            par = contrib if par is None else par + contrib
        f = ((par & 1) == 1).any(dim=0)
        fail = f if fail is None else fail | f
    return fail


def decode_layered(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Layered/TDMP min-sum: the posterior is refreshed after each base row
    (the reference C++ library's DecodeTDMP, ``decodeCL.c:203-300``).
    ``llr``: [B, n] float32, positive => bit 0.  Like the reference's jnp
    path it checks the exact syndrome after every sweep whatever
    ``cfg.syndrome_mode`` says."""
    return _decode_layered(code, cfg, llr, lazy=False)


def _decode_layered(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor,
                    lazy: bool) -> DecodeResult:
    """The layered loop of :func:`decode_layered`.  With ``lazy`` a frame
    latches on a sweep only if its on-the-fly parity check passed on that
    sweep too: the parity, per check row and layer, of ``P <= 0`` over the
    row's unmasked edges, read from the same row-aligned posterior tiles
    that give q (so before the layer's write-back).  That is the long-code
    kernel's lazy syndrome (ops/cuda_long.py, its only caller with
    ``lazy``)."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    dev = llr.device
    layers = _layers(code)
    alphas, betas = layer_weights(cfg.normalization, cfg.offset, code.m_b)
    masks_t = {
        e: torch.as_tensor(mask[:, None], device=dev)
        for (_, entries) in layers
        for (e, _, _, mask) in entries
        if mask is not None
    }

    post = _to_blocks(llr, n_b, z)
    r = torch.zeros((code.num_blocks, z, bsz), dtype=llr.dtype, device=dev)
    bits_out = torch.zeros((n_b, z, bsz), dtype=torch.bool, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        if lazy:
            pre_bad = torch.zeros((bsz,), dtype=torch.bool, device=dev)
        for li, (p0, entries) in enumerate(layers):
            qs = []
            par = None
            for (e, j, s, _) in entries:
                x = _row_align(post[j], s)
                q = x - r[e]
                if e in masks_t:
                    q = torch.where(masks_t[e], q, _Q_INF)
                qs.append(q)
                if lazy:
                    bit = (x <= 0).to(torch.int32)
                    if e in masks_t:
                        bit = torch.where(masks_t[e], bit, 0)
                    par = bit if par is None else par + bit
            r_new = _check_update_minsum(torch.stack(qs), alphas[li], betas[li])
            # delta-accumulate writeback, in row-major block order
            for idx, (e, j, s, _) in enumerate(entries):
                delta = r_new[idx] - r[e]
                if e in masks_t:
                    delta = torch.where(masks_t[e], delta, 0.0)
                post[j] += _col_align(delta, s)
            r[p0:p0 + len(entries)] = r_new
            if lazy:
                pre_bad |= ((par & 1) == 1).any(dim=0)
        bits = post <= 0
        latch = ~done & ~_syndrome_fail(bits, layers, masks_t)
        if lazy:
            latch &= ~pre_bad
        bits_out = torch.where(done.view(1, 1, -1), bits_out, bits)
        iters = torch.where(done, iters, t + 1)
        done = done | latch
        t += 1
    return DecodeResult(
        bits=_from_blocks(bits_out).to(torch.uint8),
        converged=done,
        iterations=iters,
        total_iters=torch.tensor(t, dtype=torch.int32, device=dev),
    )
