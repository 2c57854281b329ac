"""DVB-S2 LDPC (ETSI EN 302 307-1 §5.3.2) as the reference reads it: the
address table (one line per group of 360 information bits, its parity
accumulator addresses), put in z = 360 quasi-cyclic form by the row-residue
permutation, in which the program decodes it:

* address a of group g: circulant (layer a % q, column g, shift
  (-(a // q)) % 360), q = (n - k) / 360; a second address of g in the same
  layer is a second circulant of that cell, in table order;
* the accumulator: circulants (a, kb + a) and (a + 1, kb + a), shift 0,
  and its wrap (0, kb + q - 1), shift 359, without its check row 0;
* parity bit i of the standard's order is codeword position
  k + (i % q) * 360 + i // q.
"""
from __future__ import annotations

import torch

from .qc import Circulant, RefCode

__all__ = ["GROUP", "build", "encode", "parse"]

GROUP = 360


def parse(text: str) -> list:
    """One line of addresses per group (``#`` starts a comment)."""
    rows = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            rows.append(tuple(int(t) for t in line.split()))
    return rows


def build(config: dict, table: list) -> RefCode:
    """The QC form of ``config`` (``n``, ``k``) from ``table``."""
    n, k = config["n"], config["k"]
    m = n - k
    q, kb = m // GROUP, k // GROUP
    if len(table) != kb or n % GROUP or k % GROUP:
        raise ValueError(f"{len(table)} groups for k={k}, n={n}")
    cells = {}
    for g, addrs in enumerate(table):
        for a in addrs:
            if not 0 <= a < m:
                raise ValueError(f"group {g}: address {a} outside [0, {m})")
            shifts = cells.setdefault((a % q, g), [])
            s = (-(a // q)) % GROUP
            if s in shifts:
                raise ValueError(f"group {g}: two equal circulants cancel")
            shifts.append(s)
    for a in range(q):
        cells[(a, kb + a)] = [0]
        if a + 1 < q:
            cells[(a + 1, kb + a)] = [0]
    circs = []
    for (row, col) in sorted(cells):
        circs += [Circulant(row, col, s) for s in cells[(row, col)]]
    circs.append(Circulant(0, kb + q - 1, GROUP - 1, (0,)))
    circs.sort(key=lambda c: (c.row, c.col))  # stable: a cell keeps its order
    return RefCode(name=config["name"], z=GROUP, m_b=q, n_b=kb + q,
                   circulants=tuple(circs), info=(0, k))


def encode(code: RefCode, u: torch.Tensor) -> torch.Tensor:
    """[B, k] 0/1 uint8 -> [B, n]: each layer's XOR of its shifted
    information blocks, then the accumulator's running XOR in the
    standard's parity order."""
    z, q, kb = code.z, code.m_b, code.k // code.z
    blocks = u.view(u.shape[0], kb, z)
    lam = torch.zeros((u.shape[0], q, z), dtype=torch.uint8, device=u.device)
    for c in code.circulants:
        if c.col < kb:
            lam[:, c.row] ^= torch.roll(blocks[:, c.col], -c.shift, dims=1)
    std = lam.transpose(1, 2).reshape(u.shape[0], q * z)  # position r*q + layer
    par = (torch.cumsum(std, 1, dtype=torch.int32) & 1).to(torch.uint8)
    parity = par.view(u.shape[0], z, q).transpose(1, 2).reshape(u.shape[0], q * z)
    return torch.cat([u, parity], 1)
