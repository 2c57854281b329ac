"""IEEE 802.11n LDPC (IEEE Std 802.11n-2009 Annex R; Annex F of later IEEE
802.11 editions) as the reference reads it: the prototype matrix, one line
per block row of one shift per block column (-1 for a null block), lifted
by z:

* entry s >= 0 at (row i, column j): circulant (layer i, column j, shift s),
  which joins check row i*z + r to variable j*z + (r + s) % z;
* the information bits are the first k = (n_b - m_b) * z positions;
* the parity part is the standard's: the first parity column carries
  shifts (a, 0, a) at rows 0, x and m_b - 1, and parity column j >= 1 the
  staircase, shift 0 at rows j - 1 and j.  Summing every row cancels the
  staircase and the two equal shifts, so the first parity block is the sum
  of the rows' information parts (lambda_i); each next block follows from
  its row: p_{i+1} = lambda_i + P^{s_i} p_0 + p_i.
"""
from __future__ import annotations

import torch

from .qc import Circulant, RefCode

__all__ = ["build", "encode", "parse"]


def parse(text: str) -> list:
    """One line of shifts per block row (``#`` starts a comment)."""
    rows = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            rows.append(tuple(int(t) for t in line.split()))
    return rows


def build(config: dict, table: list) -> RefCode:
    """The code of ``config`` (``name``, ``n``, ``k``, ``z``) from ``table``."""
    z = config["z"]
    m_b, n_b = len(table), len(table[0])
    if any(len(row) != n_b for row in table):
        raise ValueError("the rows of the table differ in length")
    if config["n"] != n_b * z or config["k"] != (n_b - m_b) * z:
        raise ValueError(f"a {m_b} x {n_b} table at z={z} is not n={config['n']}, "
                         f"k={config['k']}")
    circs = []
    for i, row in enumerate(table):
        for j, s in enumerate(row):
            if not -1 <= s < z:
                raise ValueError(f"row {i}, column {j}: shift {s} outside [-1, {z})")
            if s >= 0:
                circs.append(Circulant(i, j, s))
    return RefCode(name=config["name"], z=z, m_b=m_b, n_b=n_b,
                   circulants=tuple(circs), info=(0, config["k"]))


def _parity_shifts(code: RefCode) -> dict:
    """{row: shift} of the first parity column, after checking that the
    parity part has the standard's structure."""
    kb, m_b = code.n_b - code.m_b, code.m_b
    cols = {}
    for c in code.circulants:
        if c.col >= kb:
            cols.setdefault(c.col - kb, {})[c.row] = c.shift
    first = cols.get(0, {})
    rows = sorted(first)
    if (len(rows) != 3 or rows[0] != 0 or rows[-1] != m_b - 1 or first[rows[1]] != 0
            or first[0] != first[m_b - 1]):
        raise ValueError(f"{code.name}: the first parity column is not (a, 0, a)")
    for j in range(1, m_b):
        if cols.get(j) != {j - 1: 0, j: 0}:
            raise ValueError(f"{code.name}: parity column {j} is not the staircase")
    return first


def encode(code: RefCode, u: torch.Tensor) -> torch.Tensor:
    """[B, k] 0/1 uint8 -> [B, n]: each row's XOR of its shifted
    information blocks (lambda), the first parity block their sum, then
    the staircase row by row."""
    z, m_b = code.z, code.m_b
    kb = code.n_b - m_b
    first = _parity_shifts(code)
    blocks = u.view(u.shape[0], kb, z)
    lam = torch.zeros((u.shape[0], m_b, z), dtype=torch.uint8, device=u.device)
    for c in code.circulants:
        if c.col < kb:
            lam[:, c.row] ^= torch.roll(blocks[:, c.col], -c.shift, dims=1)
    p0 = lam[:, 0].clone()
    for i in range(1, m_b):
        p0 ^= lam[:, i]
    parity = [p0]
    for i in range(m_b - 1):
        nxt = lam[:, i].clone()
        if i in first:
            nxt ^= torch.roll(p0, -first[i], dims=1)
        if i >= 1:
            nxt ^= parity[i]
        parity.append(nxt)
    return torch.cat([u, *parity], 1)
