"""The plain reference: a quasi-cyclic parity-check matrix and its layered
normalized/offset min-sum decoder, in plain PyTorch.

Nothing here comes from the program under test.  A code is built from its
table file by the family's module (``dvbs2.py``) as a list of
circulants; this module holds what every family shares: the circulant
list (:class:`RefCode`), the syndrome, and the decoder whose outputs the
benchmark holds the program's against.

The decoding semantics (stated in each configuration file under
``"semantics"``):

* circulant (layer i, column j, shift s) joins check row ``i*z + r`` to
  variable ``j*z + (r + s) % z``; a masked circulant leaves out the
  check rows it lists;
* the layers are the block rows in order; a layer's circulants in
  block-column order, a multi-edge cell's circulants in the order the
  family lists them;
* per layer: q = P - R (P the posterior read before the layer's update,
  f32), a masked row's q is 1e30; |R'| is the least |q| of the row's other
  edges, clamped to 1e30, less beta and floored at 0, times alpha, each an
  f32 operation in that order; its sign the parity of the other edges'
  ``q < 0``; then P += R' - R, one circulant after another in the
  layer's order, and R = R';
* after a sweep the hard decision is ``P <= 0``; a frame whose syndrome is
  zero latches its bits and the sweep count (lazy: only if, also, every
  row's parity of ``P <= 0`` read during that sweep, before each layer's
  update, was even); a frame that never latches returns the last sweep's
  bits, ``max_iters`` and converged False.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Circulant", "RefCode", "RefResult", "decode", "syndrome_ok"]

#: a masked row's q, the identity of the min
Q_INF = 1e30
#: frames decoded at once: bounds the reference's memory on the card
BLOCK_FRAMES = 4096


@dataclasses.dataclass(frozen=True)
class Circulant:
    """One shifted identity: check rows ``row*z + r`` to variables
    ``col*z + (r + shift) % z``, less the rows in ``excluded``."""

    row: int
    col: int
    shift: int
    excluded: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RefCode:
    """A QC code as the reference reads it: circulants in decoding order
    (layers ascending, a layer's in its own order)."""

    name: str
    z: int
    m_b: int
    n_b: int
    circulants: Tuple[Circulant, ...]
    #: codeword positions of the information bits
    info: Tuple[int, int]  # [start, stop)
    #: leading positions never transmitted (their LLRs are 0)
    punctured_front: int = 0

    @property
    def n(self) -> int:
        return self.n_b * self.z

    @property
    def m(self) -> int:
        return self.m_b * self.z

    @property
    def k(self) -> int:
        return self.info[1] - self.info[0]

    @property
    def edges(self) -> int:
        """Tanner-graph edges: every circulant's z rows less its masked ones."""
        return sum(self.z - len(c.excluded) for c in self.circulants)

    def layers(self) -> List[List[Circulant]]:
        out = [[] for _ in range(self.m_b)]
        for c in self.circulants:
            out[c.row].append(c)
        return out

    def h_sets(self) -> List[set]:
        """For each check row, its set of variables (for tests)."""
        rows = [set() for _ in range(self.m)]
        for c in self.circulants:
            for r in range(self.z):
                if r in c.excluded:
                    continue
                v = c.col * self.z + (r + c.shift) % self.z
                rows[c.row * self.z + r] ^= {v}
        return rows


class _Layer:
    """One layer's gather index, masks and write-back passes on a device."""

    def __init__(self, code: RefCode, circs: Sequence[Circulant], device):
        z = code.z
        r = np.arange(z)
        self.d = len(circs)
        idx = np.stack([c.col * z + (r + c.shift) % z for c in circs])  # [d, z]
        self.index = torch.as_tensor(idx.reshape(-1), dtype=torch.long, device=device)
        live = np.ones((self.d, z), dtype=bool)
        for k, c in enumerate(circs):
            live[k, list(c.excluded)] = False
        self.live = (None if live.all()
                     else torch.as_tensor(live[:, :, None], device=device))
        # the p-th circulant of each (layer, column) cell goes in pass p:
        # each pass's variables are distinct, and the passes run in order
        seen = {}
        passes: List[List[int]] = []
        for k, c in enumerate(circs):
            p = seen.get(c.col, 0)
            seen[c.col] = p + 1
            if p == len(passes):
                passes.append([])
            passes[p].append(k)
        self.passes = [(torch.as_tensor(ks, dtype=torch.long, device=device),
                        torch.as_tensor(idx[ks].reshape(-1), dtype=torch.long, device=device))
                       for ks in passes]


@dataclasses.dataclass
class RefResult:
    bits: torch.Tensor        # [B, n] uint8
    converged: torch.Tensor   # [B] bool
    iterations: torch.Tensor  # [B] int32


def _parity_bad(code_layers, bits: torch.Tensor) -> torch.Tensor:
    """[n, B] bool hard decisions -> [B] bool, True where a check fails."""
    bad = torch.zeros(bits.shape[1], dtype=torch.bool, device=bits.device)
    for lay in code_layers:
        x = bits.index_select(0, lay.index).view(lay.d, -1, bits.shape[1])
        if lay.live is not None:
            x = x & lay.live
        bad |= (x.sum(0, dtype=torch.int32) & 1).bool().any(0)
    return bad


def syndrome_ok(code: RefCode, bits: torch.Tensor) -> torch.Tensor:
    """[B, n] 0/1 codewords -> [B] bool, True where H c = 0."""
    layers = [_Layer(code, circs, bits.device) for circs in code.layers()]
    return ~_parity_bad(layers, bits.t().bool())


def _decode_block(code: RefCode, layers, llr: torch.Tensor, alpha: float,
                  beta: float, max_iters: int, early_exit: bool,
                  lazy: bool) -> RefResult:
    bsz = llr.shape[0]
    dev = llr.device
    z = code.z
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    beta_t = torch.tensor(beta, dtype=torch.float32, device=dev)
    post = llr.t().contiguous().clone()  # [n, B] f32
    msgs = [torch.zeros((lay.d, z, bsz), dtype=torch.float32, device=dev)
            for lay in layers]
    bits_out = torch.zeros((code.n, bsz), dtype=torch.bool, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    iters = torch.full((bsz,), max_iters, dtype=torch.int32, device=dev)
    for t in range(max_iters):
        if early_exit and bool(done.all()):
            break
        pre_bad = torch.zeros(bsz, dtype=torch.bool, device=dev)
        for lay, r_old in zip(layers, msgs):
            x = post.index_select(0, lay.index).view(lay.d, z, bsz)
            q = x - r_old
            if lazy:
                bit = x <= 0
                if lay.live is not None:
                    bit = bit & lay.live
                pre_bad |= (bit.sum(0, dtype=torch.int32) & 1).bool().any(0)
            if lay.live is not None:
                q = torch.where(lay.live, q, torch.tensor(Q_INF, device=dev))
            a = q.abs()
            m1, arg = a.min(0)
            first = torch.arange(lay.d, device=dev).view(-1, 1, 1) == arg.unsqueeze(0)
            m2 = torch.where(first, torch.tensor(float("inf"), device=dev), a).amin(0)
            mag = torch.where(first, m2.unsqueeze(0), m1.unsqueeze(0))
            mag = torch.clamp(mag, max=Q_INF)
            if beta:
                mag = torch.clamp(mag - beta_t, min=0.0)
            if alpha != 1.0:
                mag = mag * alpha_t
            neg = (q < 0).to(torch.int32)
            odd = ((neg.sum(0) & 1).unsqueeze(0) ^ neg).bool()
            r_new = torch.where(odd, -mag, mag)
            delta = r_new - r_old
            if lay.live is not None:
                delta = torch.where(lay.live, delta, torch.zeros((), device=dev))
            for ks, rows in lay.passes:
                post[rows] = post[rows] + delta.index_select(0, ks).reshape(-1, bsz)
            r_old.copy_(r_new)
        bits = post <= 0
        ok = ~_parity_bad(layers, bits)
        if lazy:
            ok &= ~pre_bad
        live = ~done
        bits_out = torch.where(live.unsqueeze(0), bits, bits_out)
        latch = live & ok
        iters = torch.where(latch, torch.tensor(t + 1, dtype=torch.int32, device=dev), iters)
        done |= latch
    return RefResult(bits_out.t().contiguous().to(torch.uint8), done, iters)


def decode(code: RefCode, llr: torch.Tensor, alpha: float, beta: float,
           max_iters: int, early_exit: bool = True, lazy: bool = False,
           block: int = BLOCK_FRAMES) -> RefResult:
    """Decode [B, n] f32 LLRs (positive => bit 0) by the module's
    semantics, ``block`` frames at a time."""
    if llr.dtype != torch.float32 or llr.ndim != 2 or llr.shape[1] != code.n:
        raise ValueError(f"expected float32 llr [B, {code.n}], got "
                         f"{llr.dtype} {tuple(llr.shape)}")
    layers = [_Layer(code, circs, llr.device) for circs in code.layers()]
    parts = [_decode_block(code, layers, llr[i:i + block], alpha, beta, max_iters,
                           early_exit, lazy)
             for i in range(0, llr.shape[0], block)]
    return RefResult(*(torch.cat([getattr(p, f) for p in parts])
                       for f in ("bits", "converged", "iterations")))
