"""NumPy golden-model decoder.

A direct, readable port of the numerical behaviour of the reference's CPU
golden path (``Coder::decodeCPU``, ``MyLdpc.cpp:684-784``): flooding min-sum
(no normalization), syndrome check after every iteration, early exit, hard
decision ``bit = not (posterior > 0)``.  One codeword at a time; float64 by
default.  NumPy copy of ``myldpccppapi_tpu/ops/golden.py``: the plain
version that the tests hold the C++ golden of :mod:`..native` against
(which serves the ``Coder`` decode type ``"CPU"``) — never on the hot
path.
"""
from __future__ import annotations

import numpy as np

__all__ = ["decode_golden"]


def decode_golden(
    code,
    llr: np.ndarray,
    max_iters: int = 40,
    normalization: float = 1.0,
    offset: float = 0.0,
    dtype=np.float64,
):
    """Flooding min-sum on [B, n] channel LLRs.

    Returns (bits [B, n] uint8, converged [B] bool, iters [B] int).
    """
    rows, cols = code.h_coo()
    m, n = code.m, code.n

    def group(keys, n_groups):
        """indices of each key value, O(E log E) (a per-value nonzero scan
        is O(groups * E) — minutes of precompute on DVB-S2 n=64800)."""
        order = np.argsort(keys, kind="stable")
        bounds = np.searchsorted(keys[order], np.arange(n_groups + 1))
        return [order[bounds[i]:bounds[i + 1]] for i in range(n_groups)]

    e_by_row = group(rows, m)
    e_by_col = group(cols, n)

    llr = np.atleast_2d(np.asarray(llr, dtype=dtype))
    b_sz = llr.shape[0]
    bits_out = np.zeros((b_sz, n), dtype=np.uint8)
    converged = np.zeros(b_sz, dtype=bool)
    iters = np.zeros(b_sz, dtype=np.int64)

    for b in range(b_sz):
        chan = llr[b]
        q = chan[cols].copy()          # variable->check messages per edge
        r_msg = np.zeros_like(q)       # check->variable messages per edge
        t = 0
        while True:
            # check-node update: sign product x min magnitude, excluding self
            for row_edges in e_by_row:
                vals = q[row_edges]
                a = np.abs(vals)
                neg = vals < 0
                order = np.argsort(a, kind="stable")
                m1 = a[order[0]]
                m2 = a[order[1]] if len(a) > 1 else np.inf
                tot = np.count_nonzero(neg) & 1
                mag = np.where(np.arange(len(a)) == order[0], m2, m1)
                mag = np.maximum(mag - offset, 0.0) * normalization
                sgn = np.where((tot ^ neg.astype(int)) == 1, -1.0, 1.0)
                r_msg[row_edges] = sgn * mag
            # posterior + hard decision
            post = chan.copy()
            np.add.at(post, cols, r_msg)
            hard = ~(post > 0)
            # syndrome
            fail = False
            for row_edges in e_by_row:
                if np.count_nonzero(hard[cols[row_edges]]) & 1:
                    fail = True
                    break
            t += 1
            if not fail:
                converged[b] = True
                break
            if t == max_iters:
                break
            # variable-node update
            q = post[cols] - r_msg
        bits_out[b] = hard.astype(np.uint8)
        iters[b] = t
    return bits_out, converged, iters
