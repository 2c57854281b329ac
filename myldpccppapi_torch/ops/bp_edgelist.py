"""Edge-list belief propagation for arbitrary (non-QC) parity-check matrices.

Counterpart of ``myldpccppapi_tpu/ops/bp_edgelist.py``: the decoder of
codes without circulant structure (the DVB-S2 standard-domain oracle,
random constructions), and of any QC or RS-LDPC code on request
(``implementation="edgelist"``).  The reference writes it as XLA gathers
and scatters, with no Pallas kernel; here it is torch tensor ops on the
decoder's device, in the same algebra and order, so that f32 min-sum is
bit-exact with the reference in both schedules (tests/
test_torch_edgelist.py) and equal on CUDA and the CPU (chip_smoke.py
phase 3k).

The padded dense index layout is the reference's (:func:`build_edge_index`
is a NumPy copy, identical tables included):

* ``row_edges [M, dr_max]`` -- edge ids per check row, padded with the
  sentinel ``E``;
* ``edge_col [E]`` -- variable column of each edge;
* ``col_edges [N, dc_max]`` -- edge ids per variable column, same sentinel;
* ``row_layer [M]`` -- the layer of each row (the layered schedule).

Messages live in ``[E + 1, B]`` and the posterior in ``[N + 1, B]``
(batch minor, as in the reference); the extra row is the sentinel's, so a
padded gather reads the reduction identity the reference's ``mode="fill"``
gives: ``1e30`` for the posterior (so q = 1e30 at a pad) and 0 for R.

Order of the additions.  The reference accumulates each layer's deltas
into the posterior with one XLA scatter-add, which on the CPU adds the
updates one after another in slot order (a column that one layer touches
twice -- a multi-edge cell, a DVB-S2 residue collision -- gets its two
deltas in the order of their slots).  CUDA's ``index_add_`` /
``scatter_add_`` are atomics whose order changes from run to run, so this
port uses neither: at plan time each layer's slots are split into passes,
pass p holding every column's (p+1)-th slot, and each pass is one gather,
add and unique-index write.  The flooding posterior is ``chan + sum`` of
a column's messages, summed slot by slot from 0 in index order (XLA's
reduction), in f32 for bf16 messages (``jnp.sum``'s upcast).
"""
from __future__ import annotations

import dataclasses
import functools
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import DecoderConfig, check_edgelist_config
from .bp import _PHI_MAX, _PHI_MIN, DecodeResult, msg_dtype

__all__ = ["EdgeIndex", "build_edge_index", "decode_edgelist"]

_INF = 1e30


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeIndex:
    """Padded edge-index tables for one H (host-built NumPy)."""

    n: int
    m: int
    edge_col: np.ndarray     # [E] int32
    row_edges: np.ndarray    # [M, dr_max] int32, pad = E
    col_edges: np.ndarray    # [N, dc_max] int32, pad = E
    row_layer: np.ndarray    # [M] int32: layer id per row (for layered sched)

    @property
    def num_edges(self) -> int:
        return len(self.edge_col)

    @cached_property
    def num_layers(self) -> int:
        return int(self.row_layer.max()) + 1 if len(self.row_layer) else 1


def build_edge_index(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    m: int,
    row_layer: "np.ndarray | None" = None,
) -> EdgeIndex:
    """Build padded tables from an (edge rows, edge cols) COO list."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    e = len(rows)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    row_deg = np.bincount(rows, minlength=m)
    col_deg = np.bincount(cols, minlength=n)
    dr, dc = int(row_deg.max()), int(col_deg.max())
    row_edges = np.full((m, dr), e, dtype=np.int32)
    col_edges = np.full((n, dc), e, dtype=np.int32)
    # vectorized fill: position of each edge within its row / column
    rpos = np.arange(e) - np.concatenate([[0], np.cumsum(row_deg)])[rows]
    row_edges[rows, rpos] = np.arange(e)
    corder = np.lexsort((rows, cols))
    csorted = cols[corder]
    cpos = np.arange(e) - np.concatenate([[0], np.cumsum(col_deg)])[csorted]
    col_edges[csorted, cpos] = corder
    if row_layer is None:
        row_layer = np.zeros(m, dtype=np.int32)
    return EdgeIndex(
        n=n,
        m=m,
        edge_col=cols.astype(np.int32),
        row_edges=row_edges,
        col_edges=col_edges,
        row_layer=np.asarray(row_layer, dtype=np.int32),
    )


def layer_stack(idx: EdgeIndex) -> np.ndarray:
    """The per-layer row-edge tables stacked into one ``[L, Ml, dr]``
    array, short layers padded with all-sentinel rows (the reference's
    ``re_stack``)."""
    e = idx.num_edges
    per_layer = [idx.row_edges[idx.row_layer == l] for l in range(idx.num_layers)]
    ml = max(p.shape[0] for p in per_layer)
    stack = np.full((idx.num_layers, ml, idx.row_edges.shape[1]), e, dtype=np.int32)
    for l, p in enumerate(per_layer):
        stack[l, : p.shape[0]] = p
    return stack


def column_passes(slots: np.ndarray, cols: np.ndarray) -> list:
    """Slots (ascending) and their columns split into passes: pass p holds
    each column's (p+1)-th slot, so the columns of one pass are distinct
    and adding the passes in turn adds a column's updates in slot order.
    Returns ``[(slots, cols), ...]``."""
    if not len(slots):
        return []
    order = np.argsort(cols, kind="stable")
    c_sorted = cols[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(c_sorted)) + 1])
    lengths = np.diff(np.concatenate([starts, [len(c_sorted)]]))
    rank = np.empty(len(cols), dtype=np.int64)
    rank[order] = np.arange(len(c_sorted)) - np.repeat(starts, lengths)
    return [(slots[rank == p], cols[rank == p]) for p in range(int(rank.max()) + 1)]


class _Layer(NamedTuple):
    flat: torch.Tensor    # [Ml * dr] edge ids, pad = E
    cols: torch.Tensor    # [Ml * dr] columns, pad = n
    slots: torch.Tensor   # the real slots of flat
    edges: torch.Tensor   # their edge ids
    passes: tuple         # ((slots, cols), ...): the write-back passes


class _Plan(NamedTuple):
    edge_col: torch.Tensor   # [E + 1], pad = n
    row_cols: torch.Tensor   # [M, dr] columns, pad = n (the syndrome)
    row_edges: torch.Tensor  # [M, dr], pad = E
    slots: torch.Tensor      # the real slots of row_edges, flattened
    edges: torch.Tensor      # their edge ids
    col_slots: tuple         # col_edges' columns [N] each, pad = E
    layers: tuple            # _Layer per layer (the layered schedule)
    ml: int                  # rows of a stacked layer
    slot: torch.Tensor       # arange(dr) as [1, dr, 1] (the argmin's test)


@functools.lru_cache(maxsize=16)
def _plan(idx: EdgeIndex, device: torch.device) -> _Plan:
    """The index tables of ``idx`` on ``device``, the layered schedule's
    per-layer tables and write-back passes included (cached per index and
    device)."""
    e, n = idx.num_edges, idx.n
    as_t = functools.partial(torch.as_tensor, dtype=torch.int64, device=device)
    edge_col = np.concatenate([idx.edge_col, [n]]).astype(np.int64)
    flat_rows = idx.row_edges.reshape(-1).astype(np.int64)
    real = np.flatnonzero(flat_rows != e)
    layers, ml = [], 0
    if idx.num_layers > 1:
        stack = layer_stack(idx)
        ml = stack.shape[1]
        for table in stack:
            flat = table.reshape(-1).astype(np.int64)
            slots = np.flatnonzero(flat != e)
            passes = column_passes(slots, edge_col[flat[slots]])
            layers.append(_Layer(as_t(flat), as_t(edge_col[flat]), as_t(slots),
                                 as_t(flat[slots]),
                                 tuple((as_t(s), as_t(c)) for s, c in passes)))
    return _Plan(
        edge_col=as_t(edge_col),
        row_cols=as_t(edge_col[idx.row_edges]),
        row_edges=as_t(idx.row_edges),
        slots=as_t(real),
        edges=as_t(flat_rows[real]),
        col_slots=tuple(as_t(c) for c in idx.col_edges.T),
        layers=tuple(layers),
        ml=ml,
        slot=torch.arange(idx.row_edges.shape[1], device=device).view(1, -1, 1),
    )


def _in_dtype(x: float, dt: torch.dtype) -> float:
    """The Python scalar ``x`` rounded to ``dt``, as JAX converts a weakly
    typed scalar to the array's type before the operation."""
    return float(torch.tensor(x, dtype=dt))


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = log1p(e^-x) - log1p(-e^-x) on x clamped to [1e-7, 30] (the
    clamps of ops/bp.py, as the reference shares them)."""
    x = torch.clamp(x, _PHI_MIN, _PHI_MAX)
    ex = torch.exp(-x)
    return torch.log1p(ex) - torch.log1p(-ex)


def _check_update(qr: torch.Tensor, cfg: DecoderConfig,
                  slot: "torch.Tensor | None" = None) -> torch.Tensor:
    """Check-node update on gathered row messages [M, dr, B] (pad = +1e30),
    in the reference's order: min-sum takes m1, then m2 beside the first
    argmin, then the offset, the normalization and the clamp to 1e30, in
    the message type; sum-product computes phi in f32 (bf16 messages too),
    the total a left fold in slot order.  ``slot``: ``arange(dr)`` as
    [1, dr, 1] on qr's device (made here when not given)."""
    dt = qr.dtype
    a = qr.abs()
    neg = (qr < 0).to(torch.int32)
    if cfg.algorithm == "min-sum":
        m1, am = torch.min(a, dim=1, keepdim=True)
        if slot is None:
            slot = torch.arange(qr.shape[1], device=qr.device).view(1, -1, 1)
        is_min = slot == am
        m2 = torch.where(is_min, torch.inf, a).amin(dim=1, keepdim=True)
        mag = torch.where(is_min, m2, m1)
        if cfg.offset:
            mag = torch.clamp(mag - _in_dtype(cfg.offset, dt), min=0.0)
        if cfg.normalization != 1.0:
            mag = _in_dtype(cfg.normalization, dt) * mag
        # a lone real edge in a row gets m2 = inf
        mag = torch.clamp(mag, max=_in_dtype(_INF, dt))
    else:  # sum-product, log domain
        ph = _phi(a.float())  # pad edges: phi(clip 30) ~ 0, the sum identity
        total = ph[:, 0]
        for d in range(1, ph.shape[1]):
            total = total + ph[:, d]
        mag = _phi(total.unsqueeze(1) - ph)
    sgn = (neg.sum(dim=1, keepdim=True) & 1) ^ neg  # pad sign: positive
    return torch.where(sgn == 1, -mag, mag).to(dt)


def _syndrome_fail(post: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """[N + 1, B] posterior -> bool[B], True where any check fails (the
    sentinel row, at 1e30, reads bit 0)."""
    par = (post <= 0)[plan.row_cols].sum(dim=1, dtype=torch.int32) & 1  # [M, B]
    return (par == 1).any(dim=0)


def decode_edgelist(idx: EdgeIndex, cfg: DecoderConfig, llr: torch.Tensor,
                    crc_fail=None) -> DecodeResult:
    """Decode [B, n] LLRs (positive => bit 0) for an arbitrary H given by
    its EdgeIndex, on ``llr``'s device.

    Min-sum weights must be scalars here: the padded-row layout has no
    per-base-layer structure to index a weight schedule by.

    schedule="flooding": every check from q = P - R, then the posterior
    rebuilt as the channel plus each column's messages.
    schedule="layered": the row groups of ``idx.row_layer`` one after
    another, the posterior refreshed between groups (grouped TDMP; a
    column that one group updates twice takes both deltas in slot order).
    One layer runs the flooding schedule, as in the reference.

    ``crc_fail``: optional [B, n]-bits -> bool[B] check (ops/bp.
    accept_fail_fn); the latch then needs syndrome AND check, and the
    result carries ``accepted`` (converged is the final posterior's
    syndrome or the latch, the reference's formula for this path).  The
    early exit reads ``done.all()`` once per sweep."""
    check_edgelist_config(cfg)
    b = llr.shape[0]
    dev = llr.device
    dt = msg_dtype(cfg)
    plan = _plan(idx, dev)
    n, e = idx.n, idx.num_edges
    chan = llr.to(dt).t()  # [n, B]
    post = torch.cat([chan, torch.full((1, b), _INF, dtype=dt, device=dev)])
    r = torch.zeros((e + 1, b), dtype=dt, device=dev)
    layered = cfg.schedule == "layered" and idx.num_layers > 1
    soft = cfg.soft_output
    post_out = chan if soft else None
    bits_out = torch.zeros((n, b), dtype=torch.bool, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        if layered:
            for lay in plan.layers:
                r_l = r[lay.flat]
                qr = (post[lay.cols] - r_l).view(plan.ml, -1, b)
                rn = _check_update(qr, cfg, plan.slot).view(-1, b)
                delta = rn - r_l
                for slots, cols in lay.passes:
                    post[cols] = post[cols] + delta[slots]
                r[lay.edges] = rn[lay.slots]
        else:
            q = post[plan.edge_col] - r  # the sentinel's row: 1e30 - 0
            rn = _check_update(q[plan.row_edges], cfg, plan.slot)
            r[plan.edges] = rn.view(-1, b)[plan.slots]
            # f32 for bf16 messages too: jnp.sum's accumulation type
            col_sum = torch.zeros((n, b), dtype=torch.float32, device=dev)
            for col_slot in plan.col_slots:
                col_sum = col_sum + r[col_slot]
            post[:n] = chan + col_sum.to(dt)
        bits = post[:n] <= 0
        fail = _syndrome_fail(post, plan)
        keep = done.view(1, -1)
        bits_out = torch.where(keep, bits_out, bits)
        if soft:
            post_out = torch.where(keep, post_out, post[:n])
        iters = torch.where(done, iters, t + 1)
        # acceptance latch: syndrome AND (when CRC-aided) the check
        accept = ~fail if crc_fail is None else ~fail & ~crc_fail(bits.t())
        done = done | accept
        t += 1
    if crc_fail is None:
        conv, accepted = done, None
    else:
        # done latched on syndrome AND check; frames not done carry the
        # final posterior's bits, so their syndrome comes from it
        conv, accepted = done | ~_syndrome_fail(post, plan), done
    return DecodeResult(
        bits=bits_out.t().to(torch.uint8).contiguous(),
        converged=conv,
        iterations=iters,
        total_iters=torch.tensor(t, dtype=torch.int32, device=dev),
        accepted=accepted,
        posteriors=post_out.t().contiguous() if soft else None,
    )
