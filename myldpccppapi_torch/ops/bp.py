"""Belief-propagation decoders for QC-LDPC codes, plain torch path.

Counterpart of ``myldpccppapi_tpu/ops/bp.py`` (its layered and flooding
schedules, min-sum, sum-product, SCMS and soft output) and the **plain
version** of the CUDA kernels in ``csrc/bp_layered.cu`` and
``csrc/bp_long.cu`` (whose lazy-syndrome mode it serves through the private
``_decode_layered(..., lazy=True)``): the same function written as
ordinary tensor ops, run on any device.  The f32 operation order is the
reference jnp path's, so the results are bit-exact with it
(tests/test_torch_decode.py, tests/test_torch_flooding.py) and with the
kernels (``chip_smoke.py``):

* the min-sum check update copies the jnp form: argmin, m2 over the rest,
  the clamp of ``mag`` to 1e30, then beta, then alpha;
* the layered posterior is updated by ``P += col_align(r_new - r_old)``
  per entry in row-major block order, never rebuilt from the channel plus
  R; the flooding posterior is rebuilt as ``chan + col_align(R)`` added in
  (layer, entry) order;
* every sign is taken by comparison (``q < 0``, ``P <= 0``), except the
  SCMS flip test, which reads the sign bit as the reference does (a -0.0
  message counts as negative there);
* the sum-product total is a left fold of ``phi`` in edge order, the CUDA
  kernel's order (the jnp path's ``jnp.sum`` order is XLA's, and its
  ``exp``/``log1p`` are not torch's, so sum-product agrees with the
  reference only to a tolerance);
* converged codewords latch their bits, iteration count and (soft output)
  posterior while the batch continues; the early-exit test is one host
  read of ``done.all()`` per iteration (the reference's ``lax.while_loop``
  condition).

Tensor layout: LLR/posterior ``[n_b, z, B]``; per-edge messages
``[E_b, z, B]`` row-aligned (see codes/qc.py for the alignment convention).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig

__all__ = ["DecodeResult", "decode_flooding", "decode_layered", "decode_qc",
           "layer_weights"]

_Q_INF = 1e30  # masked-row q magnitude: the min-sum / phi identity
_PHI_MIN = 1e-7   # clamp for the sum-product phi transform
_PHI_MAX = 30.0


class DecodeResult(NamedTuple):
    """Decoded hard bits plus convergence statistics."""

    bits: torch.Tensor        # [B, n] uint8 hard decisions (full codeword)
    converged: torch.Tensor   # [B] bool: syndrome == 0
    iterations: torch.Tensor  # [B] int32: iterations used per codeword
    total_iters: torch.Tensor  # 0-d int32: batch iterations executed
    #: [B, n] float32 posterior LLRs (positive => bit 0), latched at each
    #: frame's convergence like :attr:`bits`; None unless
    #: ``DecoderConfig.soft_output``
    posteriors: "torch.Tensor | None" = None

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


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)) = log1p(e^-x) - log1p(-e^-x), on x clamped
    to [1e-7, 30] (the reference's ``_check_update_sumproduct.phi``)."""
    x = torch.clamp(x, _PHI_MIN, _PHI_MAX)
    ex = torch.exp(-x)
    return torch.log1p(ex) - torch.log1p(-ex)


def _check_update_sumproduct(qs: torch.Tensor) -> torch.Tensor:
    """Log-domain sum-product check update with self-exclusion over axis 0
    (``myldpccppapi_tpu/ops/bp.py::_check_update_sumproduct``):
    |R_e| = phi(sum_j phi(|Q_j|) - phi(|Q_e|)), the sum a left fold in edge
    order as in the TPU kernel (``pallas_bp._check_update_rows``)."""
    neg = (qs < 0).to(torch.int32)
    ph = _phi(qs.abs())
    total = ph[0]
    for p in ph[1:]:
        total = total + p
    mag = _phi(total.unsqueeze(0) - ph)
    sign_excl = (neg.sum(dim=0) & 1).unsqueeze(0) ^ neg
    return torch.where(sign_excl == 1, -mag, mag)


def _check_update_fn(cfg: DecoderConfig, n_layers: int):
    """``fn(qs, layer_index)``: the config's check update, min-sum with its
    scalar or per-layer weights, or sum-product."""
    if cfg.algorithm == "sum-product":
        return lambda qs, li: _check_update_sumproduct(qs)
    alphas, betas = layer_weights(cfg.normalization, cfg.offset, n_layers)
    return lambda qs, li: _check_update_minsum(qs, alphas[li], betas[li])


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


@functools.lru_cache(maxsize=32)
def _syndrome_tables(code: QCCode, device: torch.device):
    """The exact syndrome's gather, per (code, device): for every edge e in
    block order and check row r, the posterior index j*z + (r + s) % z that
    row reads ([E*z] int64); whether row r is an edge of block e ([E, z, 1]
    bool, None when no block is masked); and the layer pointers."""
    _, bc, sh = code.blocks
    z = code.z
    idx = bc[:, None].astype(np.int64) * z + (np.arange(z)[None, :] + sh[:, None]) % z
    masks = code.block_row_masks
    live = None
    if any(m is not None for m in masks):
        live = np.stack([np.ones(z, bool) if m is None else m for m in masks])[:, :, None]
        live = torch.as_tensor(live, device=device)
    return (torch.as_tensor(idx.reshape(-1), device=device), live,
            torch.as_tensor(np.asarray(code.layer_ptr, dtype=np.int64), device=device))


def _syndrome_fail(bits_blocks: torch.Tensor, code: QCCode) -> torch.Tensor:
    """[n_b, z, B] hard bits (bool) -> [B] bool, True where any check fails.
    One gather of every edge's bit, then each layer's row parities as
    differences of an integer prefix sum over the edges (exact, so the
    order of the additions does not matter)."""
    idx, live, ptr = _syndrome_tables(code, bits_blocks.device)
    n_b, z, bsz = bits_blocks.shape
    bits = bits_blocks.reshape(n_b * z, bsz)[idx].view(-1, z, bsz)
    if live is not None:
        bits = bits & live
    ends = bits.cumsum(0, dtype=torch.int32)[ptr[1:] - 1]  # [m_b, z, B]
    par = torch.diff(ends, dim=0, prepend=torch.zeros_like(ends[:1]))
    return (par & 1).any(dim=1).any(dim=0)


def _masks(layers, dev):
    """{edge: [z, 1] bool live-row mask} of the code's row-masked blocks."""
    return {
        e: torch.as_tensor(mask[:, None], device=dev)
        for (_, entries) in layers
        for (e, _, _, mask) in entries
        if mask is not None
    }


def decode_layered(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Layered/TDMP BP: the posterior is refreshed after each base row
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
    check_update = _check_update_fn(cfg, code.m_b)
    masks_t = _masks(layers, dev)

    post = _to_blocks(llr, n_b, z)
    post_out = post.clone() if cfg.soft_output else None
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
            r_new = check_update(torch.stack(qs), li)
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
        latch = ~done & ~_syndrome_fail(bits, code)
        if lazy:
            latch &= ~pre_bad
        keep = done.view(1, 1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        if post_out is not None:
            post_out = torch.where(keep, post_out, post)
        iters = torch.where(done, iters, t + 1)
        done = done | latch
        t += 1
    return _result(bits_out, done, iters, t, post_out)


def _result(bits_out, done, iters, t, post_out) -> DecodeResult:
    return DecodeResult(
        bits=_from_blocks(bits_out).to(torch.uint8),
        converged=done,
        iterations=iters,
        total_iters=torch.tensor(t, dtype=torch.int32, device=done.device),
        posteriors=None if post_out is None else _from_blocks(post_out),
    )


def decode_flooding(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Flooding-schedule BP over the whole batch
    (``myldpccppapi_tpu/ops/bp.py::decode_flooding``; the reference C++
    library's MS/SP decoders and its fused ``decodeOnceMS``).  The
    variable-to-check messages q start at the channel LLR gathered per
    edge; each sweep updates every check from q, rebuilds the posterior as
    the channel plus the column-aligned R in (layer, entry) order, and
    forms the next q and the syndrome from that posterior.  With
    ``cfg.self_correction`` (SCMS, Savin 2008) a message whose sign bit
    flipped against the previously sent one goes out as +0.0.
    ``llr``: [B, n] float32, positive => bit 0."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    dev = llr.device
    layers = _layers(code)
    check_update = _check_update_fn(cfg, code.m_b)
    masks_t = _masks(layers, dev)

    def masked(x, e, fill):
        return torch.where(masks_t[e], x, fill) if e in masks_t else x

    chan = _to_blocks(llr, n_b, z)
    q = torch.stack([masked(_row_align(chan[j], s), e, _Q_INF)
                     for (_, entries) in layers for (e, j, s, _) in entries])
    post_out = chan if cfg.soft_output else None
    bits_out = torch.zeros((n_b, z, bsz), dtype=torch.bool, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        r = torch.cat([check_update(q[p0:p0 + len(entries)], li)
                       for li, (p0, entries) in enumerate(layers)])
        post = chan.clone()
        for (_, entries) in layers:
            for (e, j, s, _) in entries:
                post[j] += _col_align(masked(r[e], e, 0.0), s)
        bits = post <= 0
        # the next q and the syndrome read the same row-aligned posterior
        q_next = []
        fail = None
        for (_, entries) in layers:
            par = None
            for (e, j, s, _) in entries:
                post_ra = _row_align(post[j], s)
                q_next.append(masked(post_ra - r[e], e, _Q_INF))
                bit = masked((post_ra <= 0).to(torch.int32), e, 0)
                par = bit if par is None else par + bit
            f = ((par & 1) == 1).any(dim=0)
            fail = f if fail is None else fail | f
        q_next = torch.stack(q_next)
        if cfg.self_correction:
            # masked entries sit at 1e30 in q and q_next: never erased
            flip = (q != 0.0) & (torch.signbit(q_next) != torch.signbit(q))
            q_next = torch.where(flip, 0.0, q_next)
        q = q_next
        keep = done.view(1, 1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        if post_out is not None:
            post_out = torch.where(keep, post_out, post)
        iters = torch.where(done, iters, t + 1)
        done = done | ~fail
        t += 1
    return _result(bits_out, done, iters, t, post_out)


def decode_qc(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Dispatch on the schedule (the reference's ``decode_qc``).  ``llr``:
    [B, n] float32, positive => bit 0."""
    if cfg.schedule == "layered":
        return decode_layered(code, cfg, llr)
    return decode_flooding(code, cfg, llr)
