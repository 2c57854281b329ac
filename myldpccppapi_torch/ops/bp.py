"""Belief-propagation decoders for QC-LDPC codes, plain torch path.

Counterpart of ``myldpccppapi_tpu/ops/bp.py`` (its layered and flooding
schedules, min-sum, sum-product, SCMS, soft output, bf16 messages and the
CRC / outer-BCH acceptance latch) and the **plain version** of the CUDA
kernels in ``csrc/bp_layered.cu`` and ``csrc/bp_long.cu`` (whose lazy
syndrome and bf16 rounding points it serves through the private
``_decode_layered(..., lazy=True, group_rounding=True)``): the same
function written as ordinary tensor ops, run on any device.  The f32
operation order is the reference jnp path's, so the results are bit-exact
with it (tests/test_torch_decode.py, tests/test_torch_flooding.py) and with
the kernels (``chip_smoke.py``):

* the min-sum check update copies the jnp form: argmin, m2 over the rest,
  the clamp of ``mag`` to 1e30, then beta, then alpha;
* the layered posterior is updated by ``P += col_align(r_new - r_old)``
  per entry in row-major block order, never rebuilt from the channel plus
  R; the flooding posterior is rebuilt as ``chan + col_align(R)`` added in
  (layer, entry) order;
* the alignments are the code's group's (:func:`_aligners`): rolls for QC
  circulants, ``x[arange(z) ^ c]`` for RS-LDPC's additive blocks, in
  every schedule, algorithm, soft output and bf16;
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
  condition).  With ``cfg.crc`` or ``cfg.outer`` a codeword latches only
  when its syndrome AND its CRC / BCH check pass (:func:`accept_fail_fn`),
  so a wrong-codeword convergence keeps decoding, as in the reference.

bf16 messages (``cfg.msg_dtype == "bfloat16"``): the LLRs are cast to bf16,
posterior and messages are stored in bf16, and each check update computes
in f32 on the upcast q and rounds its result to bf16
(``pallas_bp._check_update_rows``); the masked-row q = 1e30 and the
weight-1 clamp stay f32.  The two TPU kernels round at different points:

* kernel A and the jnp path round after every operation: q = P - R, the
  delta r_new - r_old and P + delta are bf16 operations (``pallas_bp.py:
  302-310``), as are the flooding rebuild's adds and SCMS's next q.  Torch
  computes a bf16 elementwise op in f32 and rounds it once, so it rounds
  as they do.  This is the default, and kernel A's plain version;
* kernel C does its arithmetic in f32 on bf16 storage (``pallas_zlane.py:
  276-309``): q from the upcast P and R, r_new rounded to bf16 before its
  delta, the deltas of a column group (adjacent circulants of one column)
  added to the upcast P in f32, P rounded once per group and layer.  That
  is ``group_rounding=True``, kernel C's plain version.  In f32 the two
  are the same function.

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

__all__ = ["DecodeResult", "accept_fail_fn", "crc_fail_fn", "decode_flooding",
           "decode_layered", "decode_qc", "layer_weights", "msg_dtype",
           "outer_fail_fn"]

_Q_INF = 1e30  # masked-row q magnitude: the min-sum / phi identity
_PHI_MIN = 1e-7   # clamp for the sum-product phi transform
_PHI_MAX = 30.0


class DecodeResult(NamedTuple):
    """Decoded hard bits plus convergence statistics."""

    bits: torch.Tensor        # [B, n] uint8 hard decisions (full codeword)
    converged: torch.Tensor   # [B] bool: syndrome == 0
    iterations: torch.Tensor  # [B] int32: iterations used per codeword
    total_iters: torch.Tensor  # 0-d int32: batch iterations executed
    #: [B] bool when CRC- or outer-code-aided acceptance is configured
    #: (DecoderConfig.crc / .outer): syndrome AND the check both pass.
    #: None = syndrome-only decode, where acceptance is :attr:`converged`
    #: (use :attr:`ok`)
    accepted: "torch.Tensor | None" = None
    #: [B, n] posterior LLRs (positive => bit 0) in the message dtype
    #: (float32 or bfloat16), latched at each frame's convergence like
    #: :attr:`bits`; None unless ``DecoderConfig.soft_output``
    posteriors: "torch.Tensor | None" = None

    @property
    def ok(self) -> torch.Tensor:
        """Frame acceptance: ``accepted`` when CRC/outer-aided, else
        ``converged``."""
        return self.converged if self.accepted is None else self.accepted


def msg_dtype(cfg: "DecoderConfig | None") -> torch.dtype:
    """The torch dtype of ``cfg.msg_dtype`` (float32 without a config)."""
    return (torch.bfloat16 if cfg is not None and cfg.msg_dtype == "bfloat16"
            else torch.float32)


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


def _aligners(code):
    """(row_align, col_align) for the code's block group
    (``myldpccppapi_tpu/ops/bp.py::_aligners``): circulant rolls for
    cyclic codes; for RS-LDPC's additive blocks (``code.group == "xor"``)
    the self-inverse permutation ``y[i] = x[i ^ c]``, one gather along z
    (its index cached per shift and device)."""
    if getattr(code, "group", "cyclic") != "xor":
        return _row_align, _col_align
    z = code.z
    index = {}

    def xor_align(x: torch.Tensor, c: int) -> torch.Tensor:
        if not c:
            return x
        key = (c, x.device)
        if key not in index:
            index[key] = torch.as_tensor(np.arange(z) ^ c, device=x.device)
        return x[index[key]]

    return xor_align, xor_align


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
    row reads (j*z + (r ^ s) for the xor group) ([E*z] int64); whether row
    r is an edge of block e ([E, z, 1] bool, None when no block is
    masked); and the layer pointers."""
    _, bc, sh = code.blocks
    z = code.z
    rows = np.arange(z)[None, :]
    if getattr(code, "group", "cyclic") == "xor":
        within = rows ^ sh[:, None]
    else:
        within = (rows + sh[:, None]) % z
    idx = bc[:, None].astype(np.int64) * z + within
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


def crc_fail_fn(code, crc: str, span: "int | None" = None):
    """[B, n] bits (any device) -> bool[B] "CRC fails", for CRC-aided
    acceptance (``myldpccppapi_tpu/ops/bp.py::crc_fail_fn``).  The CRC field
    is the last L bits of the first ``span`` bits of the code's information
    block (``span`` defaults to the whole block: message || CRC is what the
    LDPC encoder sees)."""
    from ..codes.crc import CRC_POLYS, crc_check_fn

    length = CRC_POLYS[crc][0]
    k_info = code.k_info
    if span is None:
        span = k_info
    if not (length < span <= k_info):
        raise ValueError(f"CRC{crc} span must be in ({length}, {k_info}], got {span}")
    return _info_check(code, span, crc_check_fn(span - length, crc))


def outer_fail_fn(code, outer):
    """[B, n] bits -> bool[B] "outer code fails" (DecoderConfig.outer):
    ``("bch", m, t)``, the EN 302 307 BCH parity in the last m*t' bits of
    the information block, detected with one bit-matrix product
    (``myldpccppapi_tpu/ops/bp.py::outer_fail_fn``)."""
    kind, m, t = outer
    if kind != "bch":
        raise ValueError(f"unknown outer code {kind!r}")
    from ..codes.bch import bch_check_fn, bch_matrix

    par = bch_matrix(1, m, t).shape[1]
    k_info = code.k_info
    if k_info <= par:
        raise ValueError(f"outer BCH needs k_info > {par}, code has k_info={k_info}")
    return _info_check(code, k_info, bch_check_fn(k_info - par, m, t))


def _info_check(code, span: int, check):
    """``check`` (bits [B, span] -> bool[B] passes) on the first ``span``
    information bits of [B, n] codeword bits -> "fails"."""
    pos_np = np.asarray(code.info_positions)[:span]
    pos = {}  # per device

    def fail(bits_flat: torch.Tensor) -> torch.Tensor:
        dev = bits_flat.device
        if dev not in pos:
            pos[dev] = torch.as_tensor(pos_np, device=dev)
        return ~check(bits_flat[:, pos[dev]])

    return fail


def accept_fail_fn(code, cfg: DecoderConfig):
    """The combined integrity check of cfg.crc and cfg.outer: [B, n] bits
    -> bool[B] "rejected", or None when neither is set."""
    fails = []
    if cfg.crc:
        fails.append(crc_fail_fn(code, cfg.crc, cfg.crc_span))
    if cfg.outer:
        fails.append(outer_fail_fn(code, cfg.outer))
    if not fails:
        return None
    if len(fails) == 1:
        return fails[0]
    return lambda bits: fails[0](bits) | fails[1](bits)


def _accept_fail_blocks(code, cfg: DecoderConfig):
    """cfg.crc / cfg.outer -> a check on [n_b, z, B] hard bits, or None."""
    fail = accept_fail_fn(code, cfg)
    if fail is None:
        return None
    return lambda bits_blocks: fail(_from_blocks(bits_blocks))


def _mask_q(qs: torch.Tensor, entries, masks_t) -> torch.Tensor:
    """f32 q of one layer [deg, z, B] with the masked rows of its partial
    circulants at 1e30, the min-sum / phi identity (in f32: 1e30 is not a
    bf16 value)."""
    if not any(e in masks_t for (e, _, _, _) in entries):
        return qs
    return torch.stack([torch.where(masks_t[e], qs[idx], _Q_INF)
                        if e in masks_t else qs[idx]
                        for idx, (e, _, _, _) in enumerate(entries)])


def _column_groups(entries):
    """A layer's entries grouped into runs of adjacent circulants of one
    block column (a multi-edge cell; one circulant otherwise): a list of
    (j, [(index in the layer, e, shift)])."""
    groups = []
    for idx, (e, j, s, _) in enumerate(entries):
        if groups and groups[-1][0] == j:
            groups[-1][1].append((idx, e, s))
        else:
            groups.append((j, [(idx, e, s)]))
    return groups


def decode_layered(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Layered/TDMP BP: the posterior is refreshed after each base row
    (the reference C++ library's DecodeTDMP, ``decodeCL.c:203-300``).
    ``llr``: [B, n] float32, positive => bit 0.  Like the reference's jnp
    path it checks the exact syndrome after every sweep whatever
    ``cfg.syndrome_mode`` says."""
    return _decode_layered(code, cfg, llr, lazy=False)


def _decode_layered(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor,
                    lazy: bool, group_rounding: bool = False) -> DecodeResult:
    """The layered loop of :func:`decode_layered`.  With ``lazy`` a frame
    latches on a sweep only if its on-the-fly parity check passed on that
    sweep too: the parity, per check row and layer, of ``P <= 0`` over the
    row's unmasked edges, read from the same row-aligned posterior tiles
    that give q (so before the layer's write-back).  That is the long-code
    kernel's lazy syndrome.  ``group_rounding`` takes kernel C's bf16
    rounding points (module docstring); ops/cuda_long.py is the caller of
    both.  In f32 the write-back is the reference's per-edge ``P +=
    col_align(r_new - r_old)``, a column's circulants one after another."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    dev = llr.device
    dt = msg_dtype(cfg)
    # the type q and the write-back compute in: kernel C's f32, or the
    # message type (each bf16 operation rounds, as kernel A's do)
    wt = torch.float32 if group_rounding else dt
    layers = _layers(code)
    row_align, col_align = _aligners(code)
    check_update = _check_update_fn(cfg, code.m_b)
    accept_fail = _accept_fail_blocks(code, cfg)
    masks_t = _masks(layers, dev)
    groups = [_column_groups(entries) for (_, entries) in layers]

    post = _to_blocks(llr.to(dt), n_b, z)
    post_out = post.clone() if cfg.soft_output else None
    r = torch.zeros((code.num_blocks, z, bsz), dtype=dt, device=dev)
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
                x = row_align(post[j], s)
                qs.append((x.to(wt) - r[e].to(wt)).float())
                if lazy:
                    bit = (x <= 0).to(torch.int32)
                    if e in masks_t:
                        bit = torch.where(masks_t[e], bit, 0)
                    par = bit if par is None else par + bit
            qs = _mask_q(torch.stack(qs), entries, masks_t)
            r_new = check_update(qs, li).to(dt)
            # delta-accumulate writeback, in row-major block order, a
            # column's circulants added in wt and stored once
            for (j, group) in groups[li]:
                y = post[j].to(wt)
                for (idx, e, s) in group:
                    delta = r_new[idx].to(wt) - r[e].to(wt)
                    if e in masks_t:
                        delta = torch.where(masks_t[e], delta, 0.0)
                    y = y + col_align(delta, s)
                post[j] = y.to(dt)
            r[p0:p0 + len(entries)] = r_new
            if lazy:
                pre_bad |= ((par & 1) == 1).any(dim=0)
        bits = post <= 0
        accept = ~_syndrome_fail(bits, code)
        if accept_fail is not None:
            # a frame converged to a wrong codeword keeps decoding
            accept &= ~accept_fail(bits)
        latch = ~done & accept
        if lazy:
            latch &= ~pre_bad
        keep = done.view(1, 1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        if post_out is not None:
            post_out = torch.where(keep, post_out, post)
        iters = torch.where(done, iters, t + 1)
        done = done | latch
        t += 1
    return _result(code, bits_out, done, iters, t, post_out, accept_fail)


def _result(code, bits_out, done, iters, t, post_out, accept_fail) -> DecodeResult:
    if accept_fail is None:
        conv, accepted = done, None
    else:
        # done latched on syndrome AND check; the syndrome of the final
        # bits is reported apart, so converged & ~accepted shows a wrong
        # codeword the check caught
        conv, accepted = ~_syndrome_fail(bits_out, code), done
    return DecodeResult(
        bits=_from_blocks(bits_out).to(torch.uint8),
        converged=conv,
        iterations=iters,
        total_iters=torch.tensor(t, dtype=torch.int32, device=done.device),
        accepted=accepted,
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
    dt = msg_dtype(cfg)
    layers = _layers(code)
    row_align, col_align = _aligners(code)
    check_update = _check_update_fn(cfg, code.m_b)
    accept_fail = _accept_fail_blocks(code, cfg)
    masks_t = _masks(layers, dev)

    def masked(x, e, fill):
        return torch.where(masks_t[e], x, fill) if e in masks_t else x

    chan = _to_blocks(llr.to(dt), n_b, z)
    # q of a masked row is set at the check update (_mask_q), so what is
    # stored there, erased by SCMS or not, is never read
    q = torch.stack([row_align(chan[j], s)
                     for (_, entries) in layers for (_, j, s, _) in entries])
    post_out = chan if cfg.soft_output else None
    bits_out = torch.zeros((n_b, z, bsz), dtype=torch.bool, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        # the check update in f32, masked rows at an f32 1e30
        r = torch.cat([
            check_update(_mask_q(q[p0:p0 + len(entries)].float(), entries,
                                 masks_t), li).to(dt)
            for li, (p0, entries) in enumerate(layers)])
        post = chan.clone()
        for (_, entries) in layers:
            for (e, j, s, _) in entries:
                post[j] += col_align(masked(r[e], e, 0.0), s)
        bits = post <= 0
        # the next q and the syndrome read the same row-aligned posterior
        q_next = []
        fail = None
        for (_, entries) in layers:
            par = None
            for (e, j, s, _) in entries:
                post_ra = row_align(post[j], s)
                q_next.append(post_ra - r[e])
                bit = masked((post_ra <= 0).to(torch.int32), e, 0)
                par = bit if par is None else par + bit
            f = ((par & 1) == 1).any(dim=0)
            fail = f if fail is None else fail | f
        q_next = torch.stack(q_next)
        if cfg.self_correction:
            flip = (q != 0.0) & (torch.signbit(q_next) != torch.signbit(q))
            q_next = torch.where(flip, 0.0, q_next)
        q = q_next
        keep = done.view(1, 1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        if post_out is not None:
            post_out = torch.where(keep, post_out, post)
        iters = torch.where(done, iters, t + 1)
        accept = ~fail
        if accept_fail is not None:
            accept &= ~accept_fail(bits)
        done = done | accept
        t += 1
    return _result(code, bits_out, done, iters, t, post_out, accept_fail)


def decode_qc(code: QCCode, cfg: DecoderConfig, llr: torch.Tensor) -> DecodeResult:
    """Dispatch on the schedule (the reference's ``decode_qc``), with the
    CRC / outer-code latch when ``cfg`` sets one.  ``llr``: [B, n]
    float32, positive => bit 0."""
    if cfg.schedule == "layered":
        return decode_layered(code, cfg, llr)
    return decode_flooding(code, cfg, llr)
