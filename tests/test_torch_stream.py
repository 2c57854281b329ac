"""The global-posterior kernel's host side (ops/cuda_stream.py) on the CPU.

``csrc/bp_stream.cu`` runs only on a card (chip_smoke.py holds it there
against ``cuda_long.decode_qc_long_plain``).  What it consumes is tested
here:

* the stage plan: on the codes it serves (DVB-S2 64800 r1/2 and r3/4,
  16200 r1/2, NR BG1 Z=384, the staircase code of chip_smoke.py's phase
  3c) and on random QC codes with multi-edge cells, a timeline of the
  kernel's copies and write-backs shows that every (layer, column) read
  comes from a forwarded stage or from device memory read after the
  column's last write-back, at the kernel's prefetch distance (1) and,
  replayed further ahead, at 2 and 3;
* the compressed min-sum messages: ``expand_min_sum(compress_min_sum(q))``
  equals the per-edge messages of the torch layered path's check update
  (``ops/bp.py::_check_update_minsum``) bit for bit (-0.0 included), with
  ties at m1, masked rows, multi-edge layers and bf16 rounding;
* a CPU emulation of the staged sweep (:func:`staged_decode`, below) that
  takes its operands only from the plan's stages, its messages only from
  the staged records (or staged per-edge messages under sum-product) and
  its exact syndrome from a map of the hard decisions, bit-exact with
  ``decode_qc_long_plain`` (lazy and exact) and, exact, with the JAX
  package's jnp layered decode;
* the persistent grid's turns: the emulation run in the kernel's turns of
  at most ``TURN_SWEEPS`` sweeps, in its FIFO order, each resumed only from
  the written-back P and R and the codeword's sweep count, iterations and
  latch, equals the uninterrupted emulation and the plain version; the
  launcher's rule (grid, turn length, queue entries) through its Python
  mirror, and the queue's workspace;
* the launch's plan (``cuda_stream.Plan``, through ``cuda_long.plan`` on
  the CPU with the card's answers stubbed: the ``cpu_plans`` fixture) and
  its argument list, against a fake library.
"""
import collections
import contextlib
import json
import os
import pathlib
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes.dvbs2 import dvbs2 as ref_dvbs2
from myldpccppapi_tpu.codes.qc import QCCode as RefQCCode

from myldpccppapi_torch import DecoderConfig, QCCode, dvbs2, nr_code
from myldpccppapi_torch.codes import ira_encode_numpy
from myldpccppapi_torch.ops import bp, cuda_launch, cuda_long, cuda_stream
from myldpccppapi_torch.ops.bp import DecodeResult
from myldpccppapi_torch.utils import profiling
from test_torch_launch import cpu_plans  # noqa: F401 (a fixture)

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")


def staircase_base(z=360, q=54, kb=108, seed=7) -> np.ndarray:
    """chip_smoke.py's staircase_qc base matrix (the reference's
    tests/test_pallas.py::_staircase_qc at n_b = kb + q): a p0 column and a
    dual-diagonal parity part, layers of unequal degree."""
    rng = np.random.default_rng(seed)
    base = np.full((q, kb + q), -1, dtype=np.int32)
    for g in range(kb):
        deg = 8 if g < kb // 3 else 3
        for layer in rng.choice(q, size=deg, replace=False):
            base[layer, g] = int(rng.integers(0, z))
    base[0, kb] = 1
    base[q // 2, kb] = 0
    base[q - 1, kb] = 1
    for j in range(q - 1):
        base[j, kb + 1 + j] = 0
        base[j + 1, kb + 1 + j] = 0
    return base


def staircase(**kw) -> QCCode:
    return QCCode(name="staircase", base=staircase_base(**kw), z=kw.get("z", 360))


PLAN_CODES = {
    "dvbs2_64800_r12": lambda: dvbs2(64800, "1/2"),
    "dvbs2_64800_r34": lambda: dvbs2(64800, "3/4"),
    "dvbs2_16200_r12": lambda: dvbs2(16200, "1/2"),
    "nr_bg1_z384": lambda: nr_code(384, 1),
    "staircase": staircase,
}


# -- the stage plan ----------------------------------------------------------

def check_plan(code, distance: int, sweeps: int = 3) -> None:
    """Replays the kernel's schedule over ``sweeps`` sweeps: at the start of
    layer g the copies of layer g + distance are started (the first
    ``distance`` layers' before layer 0), a layer's updates are written
    back (and forwarded) before the barrier that ends it.  A loaded cell
    must see every write-back of its column; a forwarded one must be
    written by the column's previous user, into a slot no copy fills."""
    plan = cuda_stream.stage_plan(code, distance)
    m_b = code.m_b
    cells = [range(plan.col_ptr[i], plan.col_ptr[i + 1]) for i in range(m_b)]
    last_write = {}  # column -> the layer (decode count) that last wrote it
    forwarded_to = {}  # (layer, slot) -> the layer that wrote it there
    for g in range(sweeps * m_b):
        i = g % m_b
        for k, c in enumerate(cells[i]):
            col = int(plan.cols[c])
            if plan.loaded[c] or g < plan.back[c]:
                # started with layer g - distance (before layer 0
                # for the first ones): after every write of an earlier layer
                assert col not in last_write or last_write[col] < g - distance, (g, col)
            else:
                writer = forwarded_to.pop((g, k))
                assert writer == last_write[col] == g - plan.back[c], (g, col)
        for k, c in enumerate(cells[i]):
            col = int(plan.cols[c])
            last_write[col] = g  # written through
            d = int(plan.fwd_dist[c])
            if d:
                nxt = (i + d) % m_b
                target = plan.col_ptr[nxt] + plan.fwd_slot[c]
                assert plan.cols[target] == col and not plan.loaded[target]
                assert plan.back[target] == d
                forwarded_to[(g + d, int(plan.fwd_slot[c]))] = g
    # every column used ends each sweep written back; every forward was read
    assert set(last_write) == set(plan.cols.tolist())
    assert all(w >= g - m_b for w in last_write.values())
    assert all(t >= sweeps * m_b for (t, _) in forwarded_to)


@pytest.mark.parametrize("distance", [1, 2, 3])
@pytest.mark.parametrize("name", list(PLAN_CODES))
def test_stage_plan_reads_only_written_back_or_forwarded_columns(name, distance):
    code = PLAN_CODES[name]()
    check_plan(code, distance)
    plan = cuda_stream.stage_plan(code, distance)
    _, bc, _ = code.blocks
    for i in range(code.m_b):
        layer = plan.cols[plan.col_ptr[i]:plan.col_ptr[i + 1]]
        blocks = bc[code.layer_ptr[i]:code.layer_ptr[i + 1]]
        # each distinct column once, in the order of its first circulant
        np.testing.assert_array_equal(layer, list(dict.fromkeys(blocks.tolist())))
        np.testing.assert_array_equal(
            layer[plan.edge_slot[code.layer_ptr[i]:code.layer_ptr[i + 1]]], blocks)


def test_stage_plan_at_dvbs2_64800():
    """613 distinct (layer, column) cells at r1/2; at distance 1 the columns
    that consecutive layers share (the parity staircase) are forwarded, and
    a sweep moves 2.39 MB of a codeword's P and R in f32 (3.63 MB per edge)."""
    code = dvbs2(64800, "1/2")
    plan = cuda_stream.stage_plan(code, 1)
    assert plan.total_cols == 613 and plan.max_cols <= code.max_row_degree
    assert int((~plan.loaded).sum()) == 109
    moved = cuda_stream.stream_bytes(code, 4)
    assert moved == {"p_loaded": 504 * 360 * 4, "p_written": 613 * 360 * 4,
                     "r_read": 90 * 3 * 360 * 4, "r_written": 90 * 3 * 360 * 4}
    assert sum(moved.values()) < 0.66 * 2 * (code.num_blocks * 360 * 4 + code.num_edges * 4)
    assert cuda_stream.record_words(code.max_row_degree, 2) == 2  # 8 B a row in bf16


@st.composite
def random_qc(draw):
    """A random QC base matrix (every layer and column used) with some
    multi-edge cells (extra circulants on a used cell)."""
    m_b = draw(st.integers(1, 6))
    n_b = draw(st.integers(2, 9))
    z = draw(st.sampled_from([8, 13, 16]))
    used = draw(st.lists(st.lists(st.booleans(), min_size=n_b, max_size=n_b),
                         min_size=m_b, max_size=m_b))
    base = np.full((m_b, n_b), -1, dtype=np.int32)
    for i in range(m_b):
        for j in range(n_b):
            if used[i][j] or j == i % n_b:
                base[i, j] = draw(st.integers(0, z - 1))
    cells = [(i, j) for i in range(m_b) for j in range(n_b) if base[i, j] >= 0]
    extra = draw(st.lists(st.sampled_from(cells), max_size=3, unique=True))
    extra_blocks = tuple((i, j, (int(base[i, j]) + 1 + e) % z)
                         for e, (i, j) in enumerate(extra)) or None
    return QCCode(name="random", base=base, z=z, extra_blocks=extra_blocks)


@settings(max_examples=60, deadline=None)
@given(code=random_qc(), distance=st.integers(1, 4))
def test_stage_plan_on_random_codes(code, distance):
    check_plan(code, distance)


def test_kernel_table_words():
    """The shift and column words of the kernel's tables carry the plan at
    the kernel's distance: shift, cell slot and mask slot; column, loaded,
    forward slot and whether the cell is forwarded to the next layer.  A
    plan at another distance has no table words."""
    code = dvbs2(16200, "1/2")
    plan = cuda_stream.stage_plan(code)
    tables = cuda_stream._device_tables(code, 0.85, 0.0, torch.device("cpu"))
    shift, col = tables[0].numpy(), tables[4].numpy()
    _, _, sh = code.blocks
    np.testing.assert_array_equal(shift & 0x3FFF, sh)
    np.testing.assert_array_equal((shift >> 14) & 63, plan.edge_slot)
    masked = np.array([m is not None for m in code.block_row_masks])
    np.testing.assert_array_equal(shift >> 20, masked.cumsum() * masked)
    np.testing.assert_array_equal(col & 0xFFFF, plan.cols)
    np.testing.assert_array_equal((col >> 16) & 1, plan.loaded)
    np.testing.assert_array_equal((col >> 17) & 63, plan.fwd_slot)
    np.testing.assert_array_equal(col >> 23, plan.fwd_dist)
    assert set(plan.fwd_dist.tolist()) == {0, 1}
    # every forwarded cell's writer is the layer just before
    np.testing.assert_array_equal(plan.back[~plan.loaded], 1)
    with pytest.raises(ValueError, match="prefetch distance"):
        cuda_stream._table_words(code, cuda_stream.stage_plan(code, 2))


# -- the compressed messages --------------------------------------------------

def raw(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def q_rows(deg: int, z: int, batch: int, seed: int, masked_edge=None) -> torch.Tensor:
    """[deg, z, batch] f32 q with ties at the minimum, zeros of both signs
    and, on ``masked_edge``, every other row masked (q = 1e30)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 3, size=(deg, z, batch)).astype(np.float32)
    q[:, ::3] = np.round(q[:, ::3])        # ties among small integers
    if deg > 1:
        q[1, 1::5] = -q[0, 1::5]           # |q| ties at m1 by construction
    q[2 % deg, 2::7] = -0.0
    q[0, 3::11] = 0.0
    if masked_edge is not None:
        q[masked_edge, ::2] = 1e30
    return torch.from_numpy(q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deg,alpha,beta", [(1, 0.75, 0.0), (2, 1.0, 0.0), (7, 0.85, 0.0),
                                            (7, 0.8, 0.5), (14, 0.85, 0.0), (21, 1.0, 0.25),
                                            (40, 0.75, 0.0), (64, 0.85, 0.1)])
def test_codec_equals_per_edge_messages(deg, alpha, beta, dtype):
    q = q_rows(deg, 96, 3, seed=deg)
    want = bp._check_update_minsum(q, alpha, beta).to(dtype)
    words = cuda_stream.compress_min_sum(q, alpha, beta, dtype, max(deg, 24))
    assert words.dtype == torch.int32
    assert words.shape[0] == cuda_stream.record_words(max(deg, 24), dtype.itemsize)
    got = cuda_stream.expand_min_sum(words, deg, dtype)
    assert torch.equal(raw(got), raw(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_on_masked_rows(dtype):
    """A masked row's q enters at 1e30; its own message expands to 0 (the
    kernel reads r_old = 0 there), every live one as the check update's."""
    deg = 8
    q = q_rows(deg, 64, 2, seed=3, masked_edge=5)
    live = torch.ones((deg, 64, 1), dtype=torch.bool)
    live[5, ::2] = False
    want = bp._check_update_minsum(q, 0.85, 0.0).to(dtype)
    got = cuda_stream.expand_min_sum(
        cuda_stream.compress_min_sum(q, 0.85, 0.0, dtype, deg), deg, dtype, live)
    mask = live.expand_as(got)
    assert torch.equal(raw(got)[mask], raw(want)[mask])
    assert (raw(got)[~mask] == 0).all()


def test_codec_on_every_row_past_1e30():
    """A row whose every |q| passes the running minimum's 1e30 start: every
    edge takes m1s, which the record stores as m2s too."""
    q = torch.full((4, 8, 1), 3e30)
    q[1] = -3e30
    want = bp._check_update_minsum(q, 0.5, 0.0)
    got = cuda_stream.expand_min_sum(cuda_stream.compress_min_sum(q, 0.5, 0.0, torch.float32, 4),
                                     4, torch.float32)
    assert torch.equal(raw(got), raw(want))


def test_codec_on_multi_edge_layers_of_a_decode():
    """q of every layer of a DVB-S2 16200 decode (multi-edge and masked
    layers), after three sweeps of the plain path, through the codec."""
    code = dvbs2(16200, "1/2")
    llr = torch.from_numpy(dvbs2_llr(code, 2, 0.8, 21))
    cfg = DecoderConfig(normalization=0.85, max_iters=3, early_exit=False, soft_output=True)
    post = cuda_long.decode_qc_long_plain(code, cfg, llr).posteriors
    blocks = bp._to_blocks(post, code.n_b, code.z)
    masks = bp._masks(code, torch.device("cpu"))
    for li, (p0, entries) in enumerate(bp._layers(code)):
        q = bp._mask_q(torch.stack([torch.roll(blocks[j], -s, 0) for (_, j, s, _) in entries]),
                       entries, masks)
        for dtype in (torch.float32, torch.bfloat16):
            want = bp._check_update_minsum(q, 0.85, 0.0).to(dtype)
            live = torch.stack([masks.get(e, torch.ones((code.z, 1), dtype=torch.bool))
                                for (e, _, _, _) in entries])
            got = cuda_stream.expand_min_sum(
                cuda_stream.compress_min_sum(q, 0.85, 0.0, dtype, code.max_row_degree),
                len(entries), dtype, live)
            mask = live.expand_as(got)
            assert torch.equal(raw(got)[mask], raw(want)[mask]), li


# -- the staged sweep, emulated ------------------------------------------------

def staged_decode(code, cfg, llr: torch.Tensor, distance: int = 1, slots=None,
                  log=None) -> DecodeResult:
    """The kernel's sweep in torch: P and R (records, or per-edge messages
    under sum-product) in padded "device" buffers, a ring of ``distance +
    1`` stages filled from them only at the moments the kernel starts its
    copies (or by the forwards the plan names), every q from a stage, every
    r_old from a staged record (or staged messages under sum-product, as
    the kernel stages them for rows of up to 24 edges), the exact syndrome
    from a map of the written-back P's hard decisions and the latch from
    the written-back P.  The kernel runs at distance 1; other distances
    replay the plan further ahead.

    The codewords run in the kernel's turns, in its FIFO order: tickets
    0..B-1 are the codewords' first turns, then the queue's entries in the
    order their turns ended.  With ``slots`` (the persistent grid's
    blocks) a turn runs at most ``cuda_stream.turn_sweeps(B, slots,
    max_iters)`` sweeps, else each codeword runs one turn.  A turn resumes only from the
    written-back P and R, the codeword's sweep count, iterations and latch,
    with an empty ring: its first layers load every cell whose writer lies
    before the turn, and its messages.  ``log``, a dict, receives
    ``turns`` (the codeword of each turn, in order) and ``executed`` (each
    codeword's sweeps, the kernel's ``executed`` output)."""
    plan = cuda_stream.stage_plan(code, distance)
    z, zp, m_b = code.z, cuda_stream.pad_z(code.z), code.m_b
    dt = bp.msg_dtype(cfg)
    sp = cfg.algorithm == "sum-product"
    ring = distance + 1
    layers = bp._layers(code)
    masks = bp._masks(code, llr.device)
    alphas, betas = bp.layer_weights(cfg.normalization, cfg.offset, m_b)
    quantum = (cfg.max_iters if slots is None
               else cuda_stream.turn_sweeps(len(llr), slots, cfg.max_iters))
    words = []  # each codeword's state between turns
    for row in llr.to(dt):
        P = torch.zeros((code.n_b, zp), dtype=dt)
        P[:, :z] = row.view(code.n_b, z)
        # R: layer -> record words, or edge -> messages (sum-product)
        words.append(dict(P=P, R={}, t=0, it=0, done=False, bits=None, post=None))

    def run_turn(w, t_end):
        P, R = w["P"], w["R"]
        t, it, done = w["t"], w["it"], w["done"]
        g_first, g_end = t * m_b, t_end * m_b
        stages = [{"slots": [None] * plan.max_cols, "rec": None} for _ in range(ring)]

        def prefetch(a):
            i, stage = a % m_b, stages[a % ring]
            for k, c in enumerate(range(plan.col_ptr[i], plan.col_ptr[i + 1])):
                if plan.loaded[c] or a - plan.back[c] < g_first:
                    stage["slots"][k] = P[plan.cols[c]].clone()
            if a >= m_b and (not plan.record_forwarded or a - m_b < g_first):
                stage["rec"] = ([R[e].clone() for (e, _, _, _) in layers[i][1]] if sp
                                else R[i].clone())

        for a in range(g_first, min(g_first + distance, g_end)):
            prefetch(a)
        g = g_first
        while t < t_end and not (cfg.early_exit and done):
            pre_bad = False
            for i, (p0, entries) in enumerate(layers):
                if g + distance < g_end:
                    prefetch(g + distance)
                stage = stages[g % ring]
                deg = len(entries)
                c0 = plan.col_ptr[i]
                live = torch.stack([masks.get(e, torch.ones((z, 1), dtype=torch.bool))[:, 0]
                                    for (e, _, _, _) in entries])
                x = torch.stack([torch.roll(stage["slots"][plan.edge_slot[e]][:z], -s)
                                 for (e, _, s, _) in entries])
                if t == 0:
                    r_old = torch.zeros((deg, z), dtype=dt)
                elif sp:
                    r_old = torch.stack(stage["rec"])
                else:
                    r_old = cuda_stream.expand_min_sum(stage["rec"][:, :, None], deg, dt,
                                                       live[:, :, None])[:, :, 0]
                q = torch.where(live, x.float() - r_old.float(), 1e30)
                par = ((x <= 0) & live).sum(0) % 2
                pre_bad |= bool(par.any())
                if sp:
                    r_new = bp._check_update_sumproduct(q[:, :, None])[:, :, 0].to(dt)
                    for k, (e, _, _, _) in enumerate(entries):
                        R[e] = torch.where(live[k], r_new[k], R.get(e, r_new[k]))
                    if plan.record_forwarded:
                        stages[(g + m_b) % ring]["rec"] = [R[e].clone() for (e, _, _, _)
                                                           in entries]
                else:
                    rec = cuda_stream.compress_min_sum(q[:, :, None], alphas[i], betas[i], dt,
                                                       code.max_row_degree)[:, :, 0]
                    R[i] = torch.zeros((rec.shape[0], zp), dtype=torch.int32)
                    R[i][:, :z] = rec
                    if plan.record_forwarded:
                        stages[(g + m_b) % ring]["rec"] = R[i].clone()
                    r_new = cuda_stream.expand_min_sum(rec[:, :, None], deg, dt)[:, :, 0]
                delta = torch.where(live, r_new.float() - r_old.float(), 0.0)
                for (j, group) in bp._column_groups(entries):
                    k0 = group[0][0]
                    old = stage["slots"][plan.edge_slot[entries[k0][0]]][:z]
                    if len(group) == 1:  # a masked row keeps P_old as it came
                        s = group[0][2]
                        upd = torch.roll(torch.where(live[k0], (x[k0].float() + delta[k0]).to(dt),
                                                     x[k0]), s)
                    else:  # the owner adds the cell's deltas in block order
                        acc = old.float()
                        for (k, _, s) in group:
                            acc = acc + torch.roll(delta[k], s)
                        upd = acc.to(dt)
                    c = c0 + plan.edge_slot[entries[k0][0]]
                    P[j, :z] = upd
                    if plan.fwd_dist[c]:
                        target = stages[(g + plan.fwd_dist[c]) % ring]
                        target["slots"][plan.fwd_slot[c]] = P[j].clone()
                g += 1
            if not done:
                it = t + 1
                if not (cfg.syndrome_mode == "lazy" and pre_bad):
                    hard = P[:, :z] <= 0  # the map: each variable read once
                    fail = False
                    for (_, entries) in layers:
                        par = torch.zeros(z, dtype=torch.bool)
                        for (e, j, s, _) in entries:
                            live_e = masks.get(e, torch.ones((z, 1), dtype=torch.bool))[:, 0]
                            par ^= torch.roll(hard[j], -s) & live_e
                        fail |= bool(par.any())
                    if not fail:
                        done = True
                        w["bits"], w["post"] = hard.clone(), P[:, :z].clone()
            t += 1
        w.update(t=t, it=it, done=done)
        finished = (cfg.early_exit and done) or t >= cfg.max_iters
        if finished and not done:
            w["bits"] = (P[:, :z] <= 0) & (t > 0)
            w["post"] = P[:, :z].clone()
        return finished

    queue = collections.deque(range(len(words)))
    turns = []
    while queue:
        c = queue.popleft()
        turns.append(c)
        w = words[c]
        if not run_turn(w, min(w["t"] + quantum, cfg.max_iters)):
            queue.append(c)
    if log is not None:
        log.update(turns=turns, executed=[w["t"] for w in words])
    return DecodeResult(
        bits=torch.stack([w["bits"].reshape(-1) for w in words]).to(torch.uint8),
        converged=torch.tensor([w["done"] for w in words]),
        iterations=torch.tensor([w["it"] for w in words], dtype=torch.int32),
        total_iters=torch.tensor(max(w["t"] for w in words), dtype=torch.int32),
        posteriors=(torch.stack([w["post"].reshape(-1) for w in words])
                    if cfg.soft_output else None))


def dvbs2_llr(code, batch, snr_db, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = ira_encode_numpy(code, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def all_zero_llr(n, batch, seed, lo=1.5, hi=6.0) -> np.ndarray:
    """Consistent Gaussian LLRs of the all-zero codeword, mean m and variance
    2m, m from hopeless to easy over the batch (chip_smoke 3c's)."""
    rng = np.random.default_rng(seed)
    m = np.linspace(lo, hi, batch, dtype=np.float32)[:, None]
    return (m + np.sqrt(2 * m) * rng.standard_normal((batch, n))).astype(np.float32)


def assert_same(got, want, soft=False):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    if soft:
        want_post = (want.posteriors if isinstance(want.posteriors, torch.Tensor)
                     else torch.from_numpy(np.array(want.posteriors)))
        assert torch.equal(raw(got.posteriors), raw(want_post))


EMULATION_CASES = {
    # (code, LLRs, config, prefetch distance)
    "16200 exact": ("d16", dict(normalization=0.85, max_iters=12), 1),
    "16200 lazy soft": ("d16", dict(normalization=0.85, max_iters=12, syndrome_mode="lazy",
                                    soft_output=True), 2),
    "16200 bf16 no early exit": ("d16", dict(normalization=0.85, max_iters=12,
                                             msg_dtype="bfloat16", early_exit=False,
                                             soft_output=True), 1),
    "16200 sum-product": ("d16", dict(algorithm="sum-product", max_iters=6,
                                      syndrome_mode="lazy"), 1),
    "16200 sum-product exact soft": ("d16", dict(algorithm="sum-product", max_iters=6,
                                                 soft_output=True, early_exit=False), 1),
    "staircase sum-product": ("stair", dict(algorithm="sum-product", max_iters=6), 1),
    "staircase exact": ("stair", dict(normalization=0.8, max_iters=8), 1),
    "staircase lazy": ("stair", dict(normalization=0.8, max_iters=8, syndrome_mode="lazy",
                                     soft_output=True), 3),
}


@pytest.fixture(scope="module")
def emulation_inputs():
    d16 = dvbs2(16200, "1/2")
    stair = staircase()
    return {"d16": (d16, torch.from_numpy(dvbs2_llr(d16, 3, 1.0, 31))),
            "stair": (stair, torch.from_numpy(all_zero_llr(stair.n, 2, 32)))}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_staged_sweep_equals_plain_version(case, emulation_inputs):
    which, kw, distance = EMULATION_CASES[case]
    code, llr = emulation_inputs[which]
    cfg = DecoderConfig(**kw)
    got = staged_decode(code, cfg, llr, distance)
    want = cuda_long.decode_qc_long_plain(code, cfg, llr)
    assert_same(got, want, cfg.soft_output)


@pytest.mark.parametrize("which", ["dvbs2_16200", "staircase"])
def test_staged_sweep_equals_jnp_layered_decode(which):
    """Exact syndrome and soft output: the emulated sweep against the JAX
    package's jnp layered decode on the same NumPy LLRs (the staircase code
    of chip_smoke 3c cut to z = 120, q = 12 layers for the jnp compile)."""
    if which == "dvbs2_16200":
        code, rcode = dvbs2(16200, "1/2"), ref_dvbs2(16200, "1/2")
        llr = dvbs2_llr(code, 2, 1.2, 41)
    else:
        base = staircase_base(z=120, q=12, kb=24)
        code = QCCode(name="staircase_z120", base=base, z=120)
        rcode = RefQCCode(name="staircase_z120", base=base, z=120)
        llr = all_zero_llr(code.n, 3, 42)
    kw = dict(normalization=0.8, max_iters=10, soft_output=True)
    got = staged_decode(code, DecoderConfig(**kw), torch.from_numpy(llr), 1)
    want = ref.Decoder(rcode, ref.DecoderConfig(implementation="jnp", **kw))(llr)
    assert_same(got, want, soft=True)


TURN_CASES = {
    # (code, LLRs, config, the grid's slots, prefetch distance): three
    # codewords of 16200 r1/2 (multi-edge cells, a masked row) at 1.0 dB run
    # 10-12 sweeps, one never converging; the staircase's two run 4 and 8
    "16200 exact": ("d16", dict(normalization=0.85, max_iters=12), 2, 1),
    "16200 lazy soft": ("d16", dict(normalization=0.85, max_iters=12, syndrome_mode="lazy",
                                    soft_output=True), 1, 1),
    "16200 bf16 no early exit": ("d16", dict(normalization=0.85, max_iters=12,
                                             msg_dtype="bfloat16", early_exit=False,
                                             soft_output=True), 2, 1),
    "16200 sum-product lazy": ("d16", dict(algorithm="sum-product", max_iters=8,
                                           syndrome_mode="lazy"), 2, 1),
    "16200 lazy, batch at the slots": ("d16", dict(normalization=0.85, max_iters=12,
                                                   syndrome_mode="lazy"), 3, 1),
    "staircase exact no early exit": ("stair", dict(normalization=0.8, max_iters=8,
                                                    early_exit=False, soft_output=True), 1, 1),
    "staircase lazy distance 2": ("stair", dict(normalization=0.8, max_iters=8,
                                                syndrome_mode="lazy", soft_output=True), 1, 2),
}


@pytest.mark.parametrize("case", list(TURN_CASES))
def test_turns_equal_one_uninterrupted_decode(case, emulation_inputs):
    """A batch past the grid's slots decodes in turns of at most
    ``TURN_SWEEPS`` sweeps, each resumed only from the written-back P and
    R and the codeword's sweep count, iterations and latch, in the
    kernel's FIFO order: bits, converged flags, iterations, sweeps run and
    latched posteriors equal the uninterrupted staged decode and the plain
    version bit for bit.  A batch within the slots takes one turn a
    codeword."""
    which, kw, slots, distance = TURN_CASES[case]
    code, llr = emulation_inputs[which]
    cfg = DecoderConfig(**kw)
    turned, whole = {}, {}
    got = staged_decode(code, cfg, llr, distance, slots=slots, log=turned)
    assert_same(got, staged_decode(code, cfg, llr, distance, log=whole), cfg.soft_output)
    assert_same(got, cuda_long.decode_qc_long_plain(code, cfg, llr), cfg.soft_output)
    assert turned["executed"] == whole["executed"]
    batch = len(llr)
    quantum = cuda_stream.turn_sweeps(batch, slots, cfg.max_iters)
    assert quantum == (cuda_stream.TURN_SWEEPS if batch > slots else cfg.max_iters)
    # tickets 0..B-1 are the first turns; then the queue, in FIFO order
    assert turned["turns"][:batch] == list(range(batch))
    for c, sweeps in enumerate(turned["executed"]):
        assert turned["turns"].count(c) == max(1, -(-sweeps // quantum)), c
    assert len(turned["turns"]) - batch <= cuda_stream.queue_entries(batch, cfg.max_iters)
    if batch > slots:
        assert len(turned["turns"]) > batch  # some codeword took a second turn


def test_launcher_turn_rule():
    """The launcher's rule, through its mirror: turns of TURN_SWEEPS
    sweeps only when the batch exceeds the slots (and a decode runs more
    sweeps than a turn), else one turn a codeword; a queue that holds
    every later turn."""
    k = cuda_stream.TURN_SWEEPS
    assert cuda_stream.turn_sweeps(1024, 396, 30) == k
    assert cuda_stream.turn_sweeps(397, 396, 30) == k
    assert cuda_stream.turn_sweeps(396, 396, 30) == 30
    assert cuda_stream.turn_sweeps(64, 396, 30) == 30
    assert cuda_stream.turn_sweeps(1024, 396, k) == k
    assert cuda_stream.turn_sweeps(1024, 396, 2) == 2
    assert cuda_stream.queue_entries(1024, k) == 0
    assert cuda_stream.queue_entries(1024, 30) == 1024 * (-(-30 // k) - 1)
    assert cuda_stream.queue_entries(1024, 30) * 4 <= 32 * 1024  # at most 32 KB


def test_turn_rule_mirrors_the_kernel():
    """The Python mirror of the launcher's rule holds the kernel's own
    constants: the turn's sweeps and the queue's counters before its
    entries."""
    import re

    src = (pathlib.Path(cuda_stream.__file__).parent.parent / "csrc" / "bp_stream.cu").read_text()
    assert int(re.search(r"constexpr int kTurnSweeps = (\d+);", src)[1]) == cuda_stream.TURN_SWEEPS
    assert int(re.search(r"constexpr int kQueue = (\d+);", src)[1]) == cuda_stream.QUEUE_COUNTERS


def test_workspace_per_device_and_stream(monkeypatch):
    """The turn queue's workspace: zeros when made, kept for its (device,
    stream), made anew and larger when a launch needs more entries, and
    another stream's its own."""
    monkeypatch.setattr(cuda_stream, "_workspaces", {})
    n = cuda_stream.QUEUE_COUNTERS
    a = cuda_stream.workspace("cpu", 0, 10)
    assert a.dtype == torch.int32 and a.numel() == n + 10 and not a.any()
    assert cuda_stream.workspace("cpu", 0, 4) is a
    other = cuda_stream.workspace("cpu", 7, 4)
    assert other is not a and other.numel() == n + 4
    b = cuda_stream.workspace("cpu", 0, 20)
    assert b is not a and b.numel() == n + 20 and not b.any()
    assert cuda_stream.workspace("cpu", 0, 10) is b


class FakeLib:
    """Records the kernel library's calls (the library needs a card)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 3 if name.endswith("blocks_per_sm") else 0
        return call


def _launch_inputs(device, msg_dtype="bfloat16", algorithm="min-sum"):
    """D's plan of DVB-S2 16200 r1/2 (forced to the global placement) and
    two codewords' f32 LLRs."""
    code = dvbs2(16200, "1/2")
    cfg = DecoderConfig(normalization=0.85 if algorithm == "min-sum" else 1.0,
                        syndrome_mode="lazy", msg_dtype=msg_dtype, algorithm=algorithm)
    llr = torch.zeros((2, code.n), dtype=torch.float32)
    return code, cfg, llr, cuda_long.plan(code, cfg, device, cuda_long.GLOBAL)


def test_launch_passes_the_plan_to_the_kernel(monkeypatch, cpu_plans):
    """A launch of D's plan hands ldpc_bp_stream the arguments its ctypes
    signature declares: the plan's tables and sizes, padded scratches of
    the kernel's layouts, the mode flags, the stream, (no profiler
    recording) a null phase counter, and the stream's turn queue
    workspace with the entries the batch's turns need."""
    lib = FakeLib()
    monkeypatch.setattr(cuda_launch._build, "load", lambda: lib)
    code, cfg, llr, launch_plan = _launch_inputs(cpu_plans)
    assert isinstance(launch_plan, cuda_stream.Plan)
    cuda_launch.launch(launch_plan, llr)
    (name, args), = lib.calls
    argtypes, _ = cuda_stream._build._SIGNATURES[name]
    assert name == "ldpc_bp_stream" and len(args) == len(argtypes) == 35
    plan = cuda_stream.stage_plan(code)
    assert args[16:31] == (2, code.n_b, code.z, code.m_b, code.num_blocks, plan.total_cols,
                           plan.max_cols, 1, cuda_launch.group_slots(code),
                           code.max_row_degree, cfg.max_iters, 1, 1, 0, 1)
    assert args[5] is None and args[31] == 0 and args[32] is None
    entries = cuda_stream.queue_entries(2, cfg.max_iters)
    assert args[33] == cuda_stream.workspace(llr.device, 0, entries).data_ptr()
    assert args[34] == entries


@pytest.mark.parametrize("recording,algorithm,clocked", [
    (False, "min-sum", False), (True, "min-sum", True), (True, "sum-product", False)])
def test_launch_passes_the_phase_counter_while_a_profiler_records(
        monkeypatch, cpu_plans, recording, algorithm, clocked):
    """The phase counter's pointer goes to the library only while a torch
    profiler records and only for min-sum (the clocked instantiations);
    else null, and the library runs the unclocked kernel."""
    monkeypatch.setattr(cuda_stream, "_phase_counters", {})
    code, cfg, llr, plan = _launch_inputs(cpu_plans, "float32", algorithm)
    with contextlib.ExitStack() as held:
        if recording:
            held.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]))
        args = cuda_launch.prepare(plan, llr, 1)[1]
    if clocked:
        counter = cuda_stream.phase_counter(llr.device)
        assert args[32] == counter.data_ptr()
        assert counter.dtype == torch.int64 and counter.tolist() == [0] * 7
    else:
        assert args[32] is None and cuda_stream._phase_counters == {}


def test_launch_calls_the_library_inside_the_launch_span(monkeypatch, cpu_plans):
    """Under a profiler the library call lies inside ``myldpc.long.launch``,
    and a failed launch raises (D's plan, then C's)."""
    def call(*args):
        torch.ones(1)  # an operator the profiler records inside the call
        return 0
    monkeypatch.setattr(cuda_launch._build, "load",
                        lambda: types.SimpleNamespace(ldpc_bp_stream=call,
                                                      ldpc_bp_long=lambda *a: 700))
    code, cfg, llr, plan = _launch_inputs(cpu_plans)
    result, _ = cuda_launch.prepare(plan, llr, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cuda_launch.run(plan, result, (1, 2), 1)
    events = prof.events()
    span, = [e for e in events if e.name == "myldpc.long.launch"]
    op, = [e for e in events if e.name == "aten::ones"]
    assert span.time_range.start <= op.time_range.start
    assert op.time_range.end <= span.time_range.end
    with pytest.raises(RuntimeError, match="bp_long kernel launch failed: CUDA error 700"):
        cuda_launch.run(cuda_long.plan(code, cfg, cpu_plans, cuda_long.SHARED), result, (), 1)


def test_trace_writes_the_stream_phases_beside_the_trace(monkeypatch, cpu_plans, tmp_path):
    """``profiling.trace`` writes the phase cycles that clocked launches
    added during the block beside the Chrome trace, and no phase file for a
    block without one (nor do launches outside the block count)."""
    monkeypatch.setattr(cuda_stream, "_phase_counters", {})

    def call(*args):  # the clocked kernel's additions, on the CPU
        if args[32] is not None:
            cuda_stream.phase_counter("cpu").add_(torch.tensor([10, 20, 30, 4, 70, 2, 1]))
        return 0
    monkeypatch.setattr(cuda_launch._build, "load",
                        lambda: types.SimpleNamespace(ldpc_bp_stream=call))
    code, cfg, llr, plan = _launch_inputs(cpu_plans, "float32")

    def decode():
        cuda_launch.launch(plan, llr)

    with profiling.trace(str(tmp_path / "none")):
        torch.ones(1)
    assert [n[:6] for n in os.listdir(tmp_path / "none")] == ["trace_"]
    with profiling.trace(str(tmp_path / "one")):
        decode()
    decode()  # unclocked: nothing recorded
    with profiling.trace(str(tmp_path / "two")):
        decode()
        decode()
    for sub, times in (("one", 1), ("two", 2)):
        names = sorted(os.listdir(tmp_path / sub))
        assert [n.split("_")[0] for n in names] == ["stream", "trace"]
        line = json.loads((tmp_path / sub / names[0]).read_text())
        cycles = {"stage": 10 * times, "pass1": 20 * times, "pass2": 30 * times,
                  "sweep_end": 4 * times, "resident": 70 * times}
        assert line == {"cycles": cycles, "sweeps": 2 * times, "turns": times,
                        "per_frame_sweep": {k: v / (2 * times) for k, v in cycles.items()}}
    assert cuda_stream.phase_cycles() == {"stage": 30, "pass1": 60, "pass2": 90,
                                          "sweep_end": 12, "resident": 210, "sweeps": 6,
                                          "turns": 3}


def test_blocks_per_sm_of_the_global_placement_asks_bp_stream(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(cuda_stream._build, "load", lambda: lib)
    code = dvbs2(64800, "1/2")
    got = cuda_long.blocks_per_sm(code, DecoderConfig(msg_dtype="bfloat16"), cuda_long.GLOBAL)
    plan = cuda_stream.stage_plan(code)
    assert got == 3
    assert lib.calls == [("ldpc_bp_stream_blocks_per_sm",
                          (code.n_b, code.z, code.m_b, code.num_blocks, plan.total_cols,
                           plan.max_cols, 1, cuda_launch.group_slots(code),
                           code.max_row_degree, 0, 2))]
