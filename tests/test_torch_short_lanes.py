"""Kernel A's redesigned sweep (csrc/bp_layered.cu) emulated on the CPU.

The kernel runs only on a card (chip_smoke.py holds it there against
``cuda_bp.decode_qc_cuda_plain``).  What its design changes is emulated and
tested here:

* :func:`lane_decode`, a torch emulation of the kernel's sweep: each check
  row's edges split over a group of L lanes (edge ``k L + l`` on lane
  ``l``), each lane's running fold over its own edges, the group's shuffle
  merges as an xor butterfly over the lanes (m1 and m2 with multiplicity,
  the first edge at m1, the sign parity, the syndrome parity); min-sum R
  kept only as records, built from the merged fold and checked word for
  word against the codec (``cuda_stream.compress_min_sum``), r_old expanded
  from them; sum-product's total a left fold in edge order over the
  group's phi values, each phi(|q|) computed once and reused; the flooding
  rebuild reading each edge's message from its row's record through the
  kernel's column-list words (``cuda_bp.column_edges``).  It is held
  bit-exact, posteriors included, against ``decode_qc`` (the kernel's
  plain version) in f32 and bf16 at L = 1, 2, 4, 8 and at each code's own
  L (wimax 576 r1/2, r3/4B, r5/6; rs_ldpc(4, 4, 8) on the xor group; a
  multi-edge wimax code; nr_code(32, 1) on kernel B's route), and, f32
  min-sum, against the JAX package's jnp path; with a lane's K edge slots
  walked as the kernel walks them (slots past the row's end re-read its
  last edge and are masked), the fitted instantiation's five on rows of 17
  to 20 over 4 lanes (802.11n 1944 r5/6 among them);
* the sweep end of the layered modes without multi-edge cells: the last
  layer's row parities from the values its write-back stores, the syndrome
  pass over the other layers, and the sweeps whose pass a block of one
  codeword skips, counted against the plain decode's hard decisions after
  each sweep on 802.11n 1944 r5/6 below, at and far above the cell's
  threshold;
* the record built from the lanes' merge on ties at m1, every |q| past
  1e30, -0.0 and bf16;
* the tile chooser (``cuda_bp.choose_tile``) at batch 1, 70, 1024 and 8192
  on a 132-SM, 227 KB device description, the lanes rule, and the rule
  that names the instantiation (``cuda_bp.edges_per_lane``) of each shipped
  code.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import nr as ref_nr
from myldpccppapi_tpu.codes.rs_ldpc import rs_ldpc as ref_rs_ldpc
from myldpccppapi_tpu.ops.bp import decode_qc as ref_decode_qc

from myldpccppapi_torch import DecoderConfig, QCCode, interop, nr_code, rs_ldpc, wifi, wimax
from myldpccppapi_torch.codes import encode_numpy, ru_precompute
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_launch, cuda_stream
from myldpccppapi_torch.ops.bp import DecodeResult

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")
INF = 1e30
IDX_BITS = 6


def raw(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


# -- the group's merges --------------------------------------------------------

def lane_slots(deg: int, lanes: int, slots=None) -> int:
    """The edge slots a lane walks: the kernel's K (``slots``), which must
    hold the lane's share of the row, or just that share."""
    need = -(-deg // lanes)
    assert slots is None or need <= slots, (deg, lanes, slots)
    return need if slots is None else slots


def lane_fold(q: torch.Tensor, lanes: int, slots=None):
    """The fold of a row's |q| ([deg, z, B] f32) as the kernel's lane group
    computes it: each lane's running m1, m2 and first edge at m1 over its
    edges k L + l in order (K ``slots`` of them, a slot past the row's end
    re-reading its last edge and masked out), then an xor butterfly over the
    lanes (the shuffles).  Returns (m1, m2, idx) of lane 0 after checking
    that every lane holds the same."""
    deg = q.shape[0]
    a = q.abs()
    shape = (lanes,) + a.shape[1:]
    m1 = torch.full(shape, INF)
    m2 = torch.full(shape, INF)
    idx = torch.full(shape, -1, dtype=torch.int64)
    lane = torch.arange(lanes).view(-1, 1, 1)
    for k in range(lane_slots(deg, lanes, slots)):
        pos = k * lanes + lane
        valid = pos < deg
        ak = a[torch.clamp(pos, max=deg - 1).view(-1)]
        take = valid & ((ak < m1) | ((idx < 0) & (ak == m1)))
        idx = torch.where(take, pos.expand_as(idx), idx)
        m2 = torch.where(valid, torch.minimum(m2, torch.maximum(m1, ak)), m2)
        m1 = torch.where(valid, torch.minimum(m1, ak), m1)
    off = 1
    while off < lanes:
        other = torch.arange(lanes) ^ off
        o1, o2, oi = m1[other], m2[other], idx[other]
        take = (o1 < m1) | ((o1 == m1) & (oi >= 0) & ((idx < 0) | (oi < idx)))
        idx = torch.where(take, oi, idx)
        m2 = torch.minimum(torch.minimum(m2, o2), torch.maximum(m1, o1))
        m1 = torch.minimum(m1, o1)
        off <<= 1
    for x in (m1, m2, idx):
        assert (x == x[0]).all()
    return m1[0], m2[0], idx[0]


def lane_parity(bits: torch.Tensor, lanes: int, slots=None) -> torch.Tensor:
    """XOR over a row's edges ([deg, z, B] bool): each lane's parity of its
    edges (K ``slots`` of them, walked as :func:`lane_fold` walks them),
    then the xor butterfly."""
    deg = bits.shape[0]
    lane = torch.arange(lanes).view(-1, 1, 1)
    par = torch.zeros((lanes,) + bits.shape[1:], dtype=torch.int64)
    for k in range(lane_slots(deg, lanes, slots)):
        pos = k * lanes + lane
        bk = bits[torch.clamp(pos, max=deg - 1).view(-1)]
        par = par ^ ((pos < deg) & bk).to(torch.int64)  # [lanes, z, B]
    off = 1
    while off < lanes:
        par = par ^ par[torch.arange(lanes) ^ off]
        off <<= 1
    assert (par == par[0]).all()
    return par[0].to(torch.bool)


def lane_record(q: torch.Tensor, alpha: float, beta: float, dtype: torch.dtype,
                max_row_degree: int, lanes: int, slots=None) -> torch.Tensor:
    """The record words ([words, z, B] int32) the kernel's lane group
    stores for a row's q: its merged fold, alpha/beta on m1 and m2 (m2s =
    m1s where no edge is at m1), the first edge at m1 and each edge's sign
    (the row's sign parity XOR its own), packed as record.cuh packs them."""
    deg = q.shape[0]
    m1, m2, idx = lane_fold(q, lanes, slots)
    al = torch.tensor(alpha, dtype=torch.float32)
    be = torch.tensor(beta, dtype=torch.float32)
    m1s = al * torch.clamp(m1 - be, min=0.0)
    m2s = torch.where(idx < 0, m1s, al * torch.clamp(m2 - be, min=0.0))
    neg = q < 0
    parity = lane_parity(neg, lanes, slots)
    if dtype == torch.float32:
        words = [m1s.view(torch.int32).to(torch.int64), m2s.view(torch.int32).to(torch.int64)]
    else:
        half = [x.to(dtype).view(torch.int16).to(torch.int64) & 0xFFFF for x in (m1s, m2s)]
        words = [half[0] | (half[1] << 16)]
    meta = [torch.clamp(idx, min=0)] + [torch.zeros_like(idx)] * (
        cuda_stream.record_words(max_row_degree, dtype.itemsize) - len(words) - 1)
    for k in range(deg):
        bit = IDX_BITS + k
        meta[bit >> 5] = meta[bit >> 5] | ((neg[k] ^ parity).to(torch.int64) << (bit & 31))
    out = torch.stack(words + meta)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


# -- the sweep -----------------------------------------------------------------

def lane_decode(code, cfg: DecoderConfig, llr: torch.Tensor, lanes: int,
                slots=None, counts=None) -> DecodeResult:
    """Kernel A's sweep in torch, every row of every codeword at once: q of
    each edge from P and r_old (or SCMS's Q), the lanes' fold and merges
    (over K ``slots`` a lane where given),
    min-sum messages only through records (each checked against the
    codec), sum-product's phi(|q|) cached for phi(total - phi(|q|)), the
    layered delta write-back in block order or the flooding rebuild from the
    records via the column-list words, the syndrome by lane parities, the
    latch of bits and posteriors at each codeword's converging sweep.

    The sweep end of the layered modes without multi-edge cells: the last
    layer's row parities from the lanes' parities of the values its
    write-back stores (checked against the parities of the posterior after
    the sweep); a codeword with an odd row fails, and the syndrome pass
    covers the other layers.  With a ``counts`` dict, ``counts
    ["syndrome_skips"]`` gets each codeword's sweeps whose pass its block
    would skip at one codeword a block ([B] int64): the sweeps it ran in
    which it was done or had an odd last-layer row."""
    dt = bp.msg_dtype(cfg)
    z, n_b, m_b = code.z, code.n_b, code.m_b
    batch = llr.shape[0]
    xor = getattr(code, "group", "cyclic") == "xor"
    flooding = cfg.schedule == "flooding"
    sp = cfg.algorithm == "sum-product"
    scms = cfg.self_correction
    alphas, betas = bp.layer_weights(cfg.normalization, cfg.offset, m_b)
    _, bc, sh = code.blocks
    ptr = [int(x) for x in code.layer_ptr]
    rows = torch.arange(z)

    def rnd(x):
        return x.to(dt).float()

    def var(s):  # the variable row r reads: var(s)[r]
        return rows ^ int(s) if xor else (rows + int(s)) % z

    def reader(s):  # the row that reads variable v: reader(s)[v]
        return rows ^ int(s) if xor else (rows - int(s)) % z

    P = bp._to_blocks(llr.to(dt), n_b, z).float()  # a copy: P is updated in place
    C = P.clone()
    words = cuda_stream.record_words(code.max_row_degree, dt.itemsize)
    rec = [torch.zeros((words, z, batch), dtype=torch.int32) for _ in range(m_b)]
    R = torch.zeros((code.num_blocks, z, batch))
    Q = torch.stack([C[bc[e]][var(sh[e])] for e in range(code.num_blocks)]) if scms else None

    def messages(i):  # layer i's per-edge messages from its records
        return cuda_stream.expand_min_sum(rec[i], ptr[i + 1] - ptr[i], dt).float()

    def check(i, P_in):
        """Layer i's check update from P_in: its new records or R, and the
        messages and q it used."""
        edges = range(ptr[i], ptr[i + 1])
        r_old = R[ptr[i]:ptr[i + 1]].clone() if sp else messages(i)
        if scms:
            q = Q[ptr[i]:ptr[i + 1]].clone()
        else:
            q = rnd(torch.stack([P_in[bc[e]][var(sh[e])] for e in edges]) - r_old)
        if sp:
            ph = bp._phi(q.abs())  # once per edge: the kernel's cached phi
            total = torch.zeros_like(ph[0])
            for k in range(len(edges)):  # the group's fold in edge order
                total = total + ph[k]
            mag = bp._phi(total.unsqueeze(0) - ph)
            neg = lane_parity(q < 0, lanes, slots).unsqueeze(0) ^ (q < 0)
            R[ptr[i]:ptr[i + 1]] = rnd(torch.where(neg, -mag, mag))
        else:
            rec[i] = lane_record(q, float(alphas[i]), float(betas[i]), dt,
                                 code.max_row_degree, lanes, slots)
            want = cuda_stream.compress_min_sum(q, float(alphas[i]), float(betas[i]), dt,
                                                code.max_row_degree)
            assert torch.equal(rec[i], want), f"layer {i}: record != codec"
        return r_old

    sweep_end = not flooding and cuda_launch.group_slots(code) == 0
    last = range(ptr[m_b - 1], ptr[m_b])
    skips = torch.zeros(batch, dtype=torch.int64)
    done = torch.zeros(batch, dtype=torch.bool)
    it = torch.zeros(batch, dtype=torch.int32)
    bits = torch.zeros((n_b, z, batch), dtype=torch.uint8)
    post = torch.zeros_like(P)
    t = 0
    while t < cfg.max_iters and not (cfg.early_exit and bool(done.all())):
        if flooding:
            for i in range(m_b):
                check(i, P)
            col_ptr, col_words = cuda_bp.column_edges(code)
            for j in range(n_b):
                acc = C[j]
                for w in col_words[col_ptr[j]:col_ptr[j + 1]]:
                    e, layer, pos = int(w) & 511, (int(w) >> 9) & 2047, int(w) >> 20
                    assert ptr[layer] + pos == e
                    msg = R[e] if sp else messages(layer)[pos]
                    acc = rnd(acc + msg[reader(sh[e])])
                P[j] = acc
        else:
            for i in range(m_b):
                r_old = check(i, P)
                r_new = R[ptr[i]:ptr[i + 1]] if sp else messages(i)
                delta = rnd(r_new - r_old)
                # in block order: a lone circulant's variable gets P_old +
                # delta, a cell's its circulants' deltas one after another
                stored = []
                for k, e in enumerate(range(ptr[i], ptr[i + 1])):
                    stored.append(rnd(P[bc[e]][var(sh[e])] + delta[k]))
                    P[bc[e], var(sh[e])] = stored[-1]
        fail = torch.zeros(batch, dtype=torch.bool)
        passed = m_b
        if sweep_end:
            # the last layer's rows from the values its write-back stored
            # (``stored``: the last layer's), as final as the pass's reads
            odd_rows = lane_parity(torch.stack(stored) <= 0, lanes, slots)
            after = torch.stack([P[bc[e]][var(sh[e])] for e in last])
            assert torch.equal(odd_rows, lane_parity(after <= 0, lanes, slots))
            odd = odd_rows.any(dim=0)
            running = ~done if cfg.early_exit else torch.ones_like(done)
            skips += (running & (done | odd)).to(torch.int64)
            fail |= odd
            passed = m_b - 1
        for i in range(passed):
            edges = range(ptr[i], ptr[i + 1])
            p = torch.stack([P[bc[e]][var(sh[e])] for e in edges])
            fail |= lane_parity(p <= 0, lanes, slots).any(dim=0)
            if scms:
                q_new = rnd(p - messages(i))
                q_old = Q[ptr[i]:ptr[i + 1]]
                flip = (q_old != 0) & (torch.signbit(q_new) != torch.signbit(q_old))
                Q[ptr[i]:ptr[i + 1]] = torch.where(flip, torch.zeros_like(q_new), q_new)
        latch = ~done & ~fail
        it = torch.where(done, it, torch.full_like(it, t + 1))
        bits[..., latch] = (P[..., latch] <= 0).to(torch.uint8)
        post[..., latch] = P[..., latch]
        done |= latch
        t += 1
    bits[..., ~done] = ((P[..., ~done] <= 0) & (t > 0)).to(torch.uint8)
    post[..., ~done] = P[..., ~done]
    if counts is not None:
        counts["syndrome_skips"] = skips
    return DecodeResult(bp._from_blocks(bits), done, it, torch.tensor(t, dtype=torch.int32),
                        posteriors=bp._from_blocks(post).to(dt))


def assert_same(got, want, posteriors=True):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    if posteriors:
        want_post = (want.posteriors if isinstance(want.posteriors, torch.Tensor)
                     else torch.from_numpy(np.array(want.posteriors)))
        assert torch.equal(raw(got.posteriors), raw(want_post))


# -- the codes and their LLRs ----------------------------------------------------

def multi_edge_pair():
    """chip_smoke.py phase 3j's second code (ten of layer 2's twelve
    circulants in multi-edge cells), in both packages."""
    base = np.asarray(wimax(576, "1/2").base)
    extra = tuple((2, j, (int(base[2, j]) + 3 + j) % 24) for j in (3, 4, 5, 7, 11))
    kw = dict(name="wimax576r12_extra_most", base=base, z=24, extra_blocks=extra)
    return QCCode(**kw), ref.QCCode(**kw)


CODES = {  # name -> (torch code, reference code, SNR in dB or None: all-zero LLRs)
    "w12": (lambda: (wimax(576, "1/2"), ref.wimax(576, "1/2")), 2.0),
    "w34B": (lambda: (wimax(576, "3/4B"), ref.wimax(576, "3/4B")), 4.0),
    "w56": (lambda: (wimax(576, "5/6"), ref.wimax(576, "5/6")), 5.0),  # 4 lanes of 8
    "rs448": (lambda: (rs_ldpc(4, 4, 8), ref_rs_ldpc(4, 4, 8)), 3.0),
    "multi": (multi_edge_pair, 2.0),
    "nr32": (lambda: (nr_code(32, 1), ref_nr.nr_code(32, 1)), None),
}


@pytest.fixture(scope="module")
def cases():
    """Each code of CODES with 6 frames of LLRs: codewords of random
    information bits through BPSK/AWGN (NumPy noise), or for NR all-zero
    codeword LLRs from hopeless to easy with the 2Z punctured columns at 0."""
    out = {}
    for name, (make, snr) in CODES.items():
        mine, theirs = make()
        rng = np.random.default_rng(len(out) + 11)
        if snr is None:
            m = np.linspace(1.0, 4.0, 6, dtype=np.float32)[:, None]
            llr = (m + np.sqrt(2 * m) * rng.standard_normal((6, mine.n))).astype(np.float32)
            llr[:, : 2 * mine.z] = 0.0
        else:
            mats = getattr(mine, "encoder_matrices", None) or ru_precompute(mine)
            u = rng.integers(0, 2, size=(6, mats.w.shape[1]), dtype=np.uint8)
            c = encode_numpy(mats, u)
            sigma = np.float32(10 ** (-snr / 20))
            y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(
                np.float32)
            llr = (y * np.float32(2 / sigma**2)).astype(np.float32)
        out[name] = (mine, theirs, llr)
    return out


MODES = {
    "layered": dict(normalization=0.75),
    "per-layer": dict(normalization=None),
    "offset": dict(offset=0.25),
    "flooding": dict(schedule="flooding", normalization=0.75),
    "scms": dict(schedule="flooding", self_correction=True),
    "sp layered": dict(algorithm="sum-product"),
    "sp flooding": dict(schedule="flooding", algorithm="sum-product"),
}


def config(code, mode: str, dtype: str, **kw) -> DecoderConfig:
    kw = dict(MODES[mode], msg_dtype=dtype, max_iters=6, soft_output=True, **kw)
    if kw.get("normalization", 1.0) is None:
        kw["normalization"] = tuple(float(x) for x in np.linspace(0.65, 0.85, code.m_b))
    return DecoderConfig(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_lane_sweep_equals_plain_version_at_every_width(lanes, mode, dtype, cases):
    """wimax 576 r3/4B (rows of 14 and 15 edges) at every lane width, every
    mode, f32 and bf16, posteriors included."""
    code, _, llr = cases["w34B"]
    cfg = config(code, mode, dtype, early_exit=mode != "offset")
    assert_same(lane_decode(code, cfg, torch.from_numpy(llr), lanes),
                cuda_bp.decode_qc_cuda_plain(code, cfg, torch.from_numpy(llr)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["layered", "flooding", "scms", "sp layered", "sp flooding"])
@pytest.mark.parametrize("name", ["w12", "w56", "rs448", "multi"])
def test_lane_sweep_equals_plain_version_on_each_code(name, mode, dtype, cases):
    """Each code at the kernel's own lane width (cuda_bp.lanes)."""
    code, _, llr = cases[name]
    cfg = config(code, mode, dtype)
    assert_same(lane_decode(code, cfg, torch.from_numpy(llr), cuda_bp.lanes(code)),
                cuda_bp.decode_qc_cuda_plain(code, cfg, torch.from_numpy(llr)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_b_lane_sweep_equals_plain_version(dtype, cases):
    """nr_code(32, 1) (310 circulants, rows of up to 21) on kernel B's route:
    layered min-sum, 4 lanes of up to 8 edges; LLR-0 punctured columns."""
    code, _, llr = cases["nr32"]
    assert cuda_bp.supported(code, DecoderConfig()) and cuda_bp.lanes(code) == 4
    cfg = DecoderConfig(normalization=0.8, max_iters=6, msg_dtype=dtype, soft_output=True)
    assert_same(lane_decode(code, cfg, torch.from_numpy(llr), 4),
                cuda_bp.decode_qc_cuda_plain(code, cfg, torch.from_numpy(llr)))


def trimmed_wimax_r56(deg: int) -> QCCode:
    """wimax 576 r5/6 (rows of 20 circulants, z = 24) with each row cut to
    ``deg`` circulants: a different few of its information blocks nulled
    in each row, the parity part kept."""
    base = np.array(wimax(576, "5/6").base)
    for i in range(base.shape[0]):
        info = np.flatnonzero(base[i, :20] >= 0)
        base[i, info[i::4][:20 - deg]] = -1
    return QCCode(name=f"wimax_n576_r56_rows{deg}", base=base, z=24)


FITTED_CODES = {  # name -> code: rows of 17 to 20 over 4 lanes, five slots a lane
    "rows17": lambda: trimmed_wimax_r56(17),
    "rows18": lambda: trimmed_wimax_r56(18),
    "rows19": lambda: trimmed_wimax_r56(19),
    "w56": lambda: wimax(576, "5/6"),
    "wifi1944r56": lambda: wifi(1944, "5/6"),  # rows of 20, 20, 20 and 19
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["layered", "per-layer", "offset"])
@pytest.mark.parametrize("name", list(FITTED_CODES))
def test_fitted_lane_sweep_equals_plain_version(name, mode, dtype):
    """The fitted instantiation's sweep: 4 lanes of five edge slots (the
    slots past a row of 17 to 19 re-read its last edge, masked), layered
    min-sum on cyclic codes without multi-edge cells, f32 and bf16,
    posteriors included; all-zero codeword LLRs from hopeless to easy."""
    code = FITTED_CODES[name]()
    assert code.max_row_degree == (int(name[4:]) if name.startswith("rows") else 20)
    assert cuda_bp.lanes(code) == 4 and cuda_bp.edges_per_lane(code) == 5
    rng = np.random.default_rng(code.max_row_degree + code.z)
    m = np.linspace(1.0, 4.0, 6, dtype=np.float32)[:, None]
    llr = torch.from_numpy(
        (m + np.sqrt(2 * m) * rng.standard_normal((6, code.n))).astype(np.float32))
    cfg = config(code, mode, dtype, early_exit=mode != "offset")
    assert_same(lane_decode(code, cfg, llr, 4, slots=5),
                cuda_bp.decode_qc_cuda_plain(code, cfg, llr))


def plain_syndrome_skips(code, cfg: DecoderConfig, llr: torch.Tensor) -> int:
    """The sweeps, summed over the frames, in which a frame has an odd row
    in its code's last block row, up to its own sweep count (the sweep it
    latched in, or its last): each sweep's hard decisions from a plain
    decode (``decode_qc_cuda_plain``) of that many sweeps, its posterior
    (a frame that has not latched yet returns it), the parity of each last
    block row's variables over ``P <= 0``."""
    iters = cuda_bp.decode_qc_cuda_plain(code, cfg, llr).iterations.to(torch.int64)
    br, bc, sh = (np.asarray(x) for x in code.blocks)
    rows = np.arange(code.z)
    last = [bc[e] * code.z + (rows + sh[e]) % code.z for e in np.flatnonzero(br == code.m_b - 1)]
    total = 0
    for s in range(1, int(iters.max()) + 1):
        few = dataclasses.replace(cfg, max_iters=s, soft_output=True)
        hard = cuda_bp.decode_qc_cuda_plain(code, few, llr).posteriors <= 0  # [B, n]
        odd = torch.zeros((llr.shape[0], code.z), dtype=torch.bool)
        for cols in last:
            odd ^= hard[:, torch.from_numpy(cols)]
        total += int((odd.any(dim=1) & (iters >= s)).sum())
    return total


@pytest.mark.parametrize("snr_db,regime", [(2.0, "all 40"), (5.75, "the cell's"),
                                           (9.0, "1 to 2")])
def test_sweep_end_skips_equal_the_plain_count(snr_db, regime):
    """802.11n 1944 r5/6 at the cell's decoder (layered min-sum, alpha 0.75,
    40 sweeps, early exit), 16 frames of random codewords: the sweeps whose
    syndrome pass the emulated kernel skips, at one codeword a block, equal
    the count from the plain decode's hard decisions after each sweep, and
    the decode stays bit-exact; below the threshold every frame runs 40
    sweeps, far above it one or two."""
    code = wifi(1944, "5/6")
    rng = np.random.default_rng(int(snr_db * 100))
    mats = ru_precompute(code)
    c = encode_numpy(mats, rng.integers(0, 2, size=(16, mats.w.shape[1]), dtype=np.uint8))
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    llr = torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32))
    cfg = DecoderConfig(normalization=0.75, max_iters=40, soft_output=True)
    counts = {}
    got = lane_decode(code, cfg, llr, 4, slots=5, counts=counts)
    want = cuda_bp.decode_qc_cuda_plain(code, cfg, llr)
    assert_same(got, want)
    iters = want.iterations
    if regime == "all 40":
        assert bool((iters == 40).all())
    elif regime == "1 to 2":
        assert int(iters.max()) <= 2 and bool(want.converged.all())
    else:
        assert int(iters.min()) < int(iters.max())
    skips = int(counts["syndrome_skips"].sum())
    assert skips == plain_syndrome_skips(code, cfg, llr)
    # a latching sweep is never skipped; below the threshold most are
    assert skips <= int(iters.sum()) - int(want.converged.sum())
    assert regime == "1 to 2" or skips > 0


JNP_CASES = {  # (code, config fields)
    "w12 layered": ("w12", dict(normalization=0.75)),
    "w34B layered": ("w34B", dict(normalization=0.75)),
    "w34B flooding": ("w34B", dict(schedule="flooding", normalization=0.75)),
    "rs448 layered": ("rs448", dict(normalization=0.75)),
    "multi layered": ("multi", dict(normalization=0.75)),
    "nr32 layered": ("nr32", dict(normalization=0.8)),
}


@pytest.mark.parametrize("case", list(JNP_CASES))
def test_lane_sweep_equals_jnp_path(case, cases):
    """f32 min-sum against the JAX package's jnp decode (the reference's own
    jnp path on the CPU) on the same NumPy LLRs, posteriors included."""
    name, kw = JNP_CASES[case]
    code, rcode, llr = cases[name]
    kw = dict(kw, max_iters=6, soft_output=True)
    got = lane_decode(code, DecoderConfig(**kw), torch.from_numpy(llr), cuda_bp.lanes(code))
    want = jax.jit(partial(ref_decode_qc, rcode, ref.DecoderConfig(**kw)))(jnp.asarray(llr))
    assert_same(got, want)


# -- the record from the lanes' merge ---------------------------------------------

def q_rows(deg: int, z: int, batch: int, seed: int) -> torch.Tensor:
    """[deg, z, batch] f32 q with ties at the minimum across lanes, zeros of
    both signs, and rows whose every |q| passes 1e30."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 3, size=(deg, z, batch)).astype(np.float32)
    q[:, ::3] = np.round(q[:, ::3])         # ties among small integers
    if deg > 1:
        q[deg - 1, 1::5] = -q[0, 1::5]      # |q| ties at m1 on the first and last lanes
        q[1, 1::5] = q[0, 1::5]
    q[2 % deg, 2::7] = -0.0
    q[0, 3::11] = 0.0
    q[:, 4::13] = 3e30 * np.sign(q[:, 4::13] + 0.5)  # every |q| past 1e30
    return torch.from_numpy(q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("deg,alpha,beta", [(2, 1.0, 0.0), (7, 0.85, 0.0), (15, 0.75, 0.25),
                                            (21, 0.8, 0.0), (32, 0.75, 0.0)])
def test_lane_record_round_trip(deg, alpha, beta, lanes, dtype):
    """The record the lanes' merge builds equals the codec's, and expands
    to the per-edge messages of the plain check update bit for bit (-0.0,
    ties at m1 and rows past 1e30 included)."""
    q = q_rows(deg, 48, 2, seed=deg + lanes)
    words = lane_record(q, alpha, beta, dtype, max(deg, 26), lanes)
    assert torch.equal(words, cuda_stream.compress_min_sum(q, alpha, beta, dtype, max(deg, 26)))
    want = bp._check_update_minsum(q, alpha, beta).to(dtype)
    got = cuda_stream.expand_min_sum(words, deg, dtype)
    assert torch.equal(raw(got), raw(want))
    if deg > 2:  # a zero magnitude signed negative by a third edge's sign
        assert (raw(got) == raw(torch.tensor(-0.0, dtype=dtype))).any()


def test_lane_fold_takes_the_first_edge_at_m1():
    """Ties at m1 on several lanes: the merge keeps the first edge in row
    order, whichever lane holds it."""
    q = torch.tensor([5.0, 2.0, 7.0, -2.0, 2.0, 9.0, 3.0]).view(7, 1, 1)
    for lanes in (1, 2, 4, 8):
        m1, m2, idx = lane_fold(q, lanes)
        assert (float(m1), float(m2), int(idx)) == (2.0, 2.0, 1)
    m1, m2, idx = lane_fold(torch.full((5, 1, 1), 3e30), 4)
    inf = float(torch.tensor(INF, dtype=torch.float32))  # the kernel's f32 1e30
    assert (float(m1), float(m2), int(idx)) == (inf, inf, -1)


# -- the launch shape ----------------------------------------------------------

#: a 132-SM, 227 KB device: per SM 228 KB of shared memory (1 KB of it
#: reserved per block), 2048 threads, 32 blocks, 65536 registers
H100 = dict(sms=132, smem_block=232448, smem_sm=233472, reserved=1024, threads=2048,
            blocks=32, regs=65536)


def model_smem(code, mode_bits: int, tile: int, itemsize: int = 4) -> int:
    """csrc/bp_layered.cu's shared-memory layout (its layout()) for a block
    of ``tile`` codewords: P, C (flooding), the records or R, Q (SCMS), D
    (layered multi-edge), each 16-byte aligned, then the tables."""
    def a16(x):
        return (x + 15) // 16 * 16
    flooding, sp, scms = mode_bits & 1, mode_bits & 2, mode_bits & 4
    z, n, m_b, blocks = code.z, code.n, code.m_b, code.num_blocks
    gs = cuda_launch.group_slots(code)
    r = (blocks * z * itemsize if sp
         else m_b * cuda_stream.record_words(code.max_row_degree, itemsize) * z * 4)
    total = a16(tile * n * itemsize) + (a16(tile * n * itemsize) if flooding else 0)
    total += a16(tile * r) + (a16(tile * blocks * z * itemsize) if scms else 0)
    total += 0 if flooding else a16(tile * gs * z * itemsize)
    words = 2 * m_b + blocks + m_b + 1 + tile
    words += (code.n_b + 1 + blocks) if flooding else ((blocks + m_b) if gs else 0)
    return total + 4 * words


def model_blocks_per_sm(code, mode_bits: int, regs_per_thread: int, dev=H100) -> list:
    """Blocks of 1, 2, ... codewords one SM of ``dev`` holds at once (the
    occupancy rule: warps, registers in 256-register warp allocations,
    shared memory, the block limit), up to the last tile that fits."""
    out = []
    per_cw = code.z * cuda_bp.lanes(code)
    for tile in range(1, 1024 // per_cw + 1):
        warps = -(-per_cw * tile // 32)
        smem = model_smem(code, mode_bits, tile)
        if smem > dev["smem_block"]:
            break
        blocks = min(dev["blocks"], dev["threads"] // (32 * warps),
                     dev["regs"] // (warps * (-(-regs_per_thread * 32 // 256) * 256)),
                     dev["smem_sm"] // (smem + dev["reserved"]))
        if blocks == 0:
            break
        out.append(blocks)
    return out


@pytest.mark.parametrize("name,mode_bits,want", [
    # 96 threads a codeword, 21 resident an SM at any tile: one codeword a block
    ("w34B", 0, {1: 1, 70: 1, 1024: 1, 8192: 1}),
    # 32 threads a codeword, the 32-block limit: 8192 needs two a block
    ("rs448", 0, {1: 1, 70: 1, 1024: 1, 8192: 2}),
    # flooding sum-product: 13.9 KB a codeword, shared memory bounds the SM
    ("w34B", 3, {1: 1, 70: 1, 1024: 1, 8192: 2}),
])
def test_tile_chooser_spreads_the_batch(name, mode_bits, want, cases):
    code = cases[name][0]
    blocks = model_blocks_per_sm(code, mode_bits, regs_per_thread=32)
    for batch, tile in want.items():
        assert cuda_bp.choose_tile(batch, H100["sms"], blocks) == tile, batch
    # a tile that fits nothing: not served
    assert cuda_bp.choose_tile(1, H100["sms"], []) == 0
    # state per codeword: wimax 576 r3/4B layered f32 is P + 6 x 24 x 12 B
    if name == "w34B" and mode_bits == 0:
        assert model_smem(code, 0, 1) - model_smem(code, 0, 0) - 4 == 2304 + 6 * 24 * 12


def test_lanes_rule():
    """Four edges a lane while a codeword's lanes stay within 128 threads,
    else eight (the wide instantiation); rows past 64 edges are refused."""
    assert [cuda_bp.lanes(wimax(576, r)) for r in ("1/2", "3/4B", "5/6")] == [2, 4, 4]
    assert cuda_bp.lanes(rs_ldpc()) == 4 and cuda_bp.lanes(nr_code(32, 1)) == 4
    assert cuda_bp.lanes(rs_ldpc(4, 4, 8)) == 2 and cuda_bp.lanes(wimax(2304, "1/2")) == 1
    for code in (wimax(576, "5/6"), rs_ldpc(), nr_code(32, 1)):
        assert code.max_row_degree > 4 * cuda_bp.lanes(code)  # wide
        assert code.max_row_degree <= 8 * cuda_bp.lanes(code)
    wide = QCCode(name="wide", base=np.zeros((2, 65), np.int32), z=4)
    assert cuda_bp.lanes(wide) == 0 and not cuda_bp.supported(wide)


def multi_edge_wimax_r56() -> QCCode:
    code = wimax(576, "5/6")
    return QCCode(name="wimax_n576_r56_cell", base=code.base, z=code.z,
                  extra_blocks=((1, 1, 7),))


@pytest.mark.parametrize("make,mode_bits,tile,want", [
    (lambda: wifi(1944, "5/6"), 0, 1, 5),        # the wifi cell's code: rows of 20 over 4 lanes
    (lambda: wifi(1944, "5/6"), 1, 1, 8),        # flooding
    (lambda: wifi(1944, "5/6"), 2, 1, 8),        # sum-product
    (lambda: wifi(1944, "5/6"), 5, 1, 8),        # SCMS
    (lambda: wifi(1944, "3/4"), 0, 1, 8),        # rows of 15 over 2 lanes: 8 slots
    (lambda: wifi(1944, "2/3"), 0, 1, 8),        # rows of 11 over 2 lanes: 6 slots
    (lambda: wimax(576, "3/4B"), 0, 1, 4),       # narrow
    (lambda: wimax(2304, "5/6"), 0, 1, 5),       # 4 lanes x 96 = 384 threads
    (lambda: wimax(2304, "2/3A"), 0, 2, 5),      # rows of 10 over 2 lanes, 384 threads
    (lambda: wimax(576, "5/6"), 0, 4, 5),        # 384 threads
    (lambda: wimax(576, "5/6"), 0, 5, 8),        # 480 threads: past the fitted cap
    (multi_edge_wimax_r56, 0, 1, 8),             # a multi-edge cell
    (rs_ldpc, 0, 1, 8),                          # the xor group, rows of 32
    (lambda: nr_code(32, 1), 0, 1, 8),           # kernel B's route: rows of 21, 6 slots
], ids=["wifi1944r56", "flooding", "sum-product", "scms", "wifi1944r34", "wifi1944r23",
        "wimax576r34B", "wimax2304r56", "wimax2304r23A", "wimax576r56-tile4",
        "wimax576r56-tile5", "multi-edge", "rs_ldpc", "route-b"])
def test_instantiation_rule(make, mode_bits, tile, want):
    """The instantiation of each shipped code, by its shape: five slots a
    lane only for layered min-sum on a cyclic code without multi-edge cells
    that the wide rule takes, whose rows need at most five a lane, in blocks
    of at most 384 threads; the host's thread cap is the fitted one's there,
    so the tiles the occupancy query offers all run it."""
    code = make()
    assert (cuda_launch.group_slots(code) > 0) == (code.name == "wimax_n576_r56_cell")
    assert cuda_bp.edges_per_lane(code, mode_bits, tile) == want
    width = cuda_bp.lanes(code)
    cap = cuda_bp._max_threads(code, mode_bits)
    if cuda_bp.edges_per_lane(code, mode_bits) == 5:
        assert cap == 384
        for t in range(1, cap // (code.z * width) + 1):
            assert cuda_bp.edges_per_lane(code, mode_bits, t) == 5
    else:
        assert cap == (1024 if want == 4 else 512)


def test_edge_and_column_words():
    """The kernel's tables: an edge word holds col * z above the shift's
    10 bits; a column-list word the block, its layer and its position in
    its row, the column's blocks ascending."""
    code = multi_edge_pair()[0]
    _, bc, sh = code.blocks
    words = cuda_bp.edge_words(code)
    np.testing.assert_array_equal(words >> 10, bc * code.z)
    np.testing.assert_array_equal(words & 1023, sh)
    col_ptr, col_words = cuda_bp.column_edges(code)
    e, layer, pos = col_words & 511, (col_words >> 9) & 2047, col_words >> 20
    np.testing.assert_array_equal(np.asarray(code.layer_ptr)[layer] + pos, e)
    for j in range(code.n_b):
        blocks = e[col_ptr[j]:col_ptr[j + 1]]
        assert (bc[blocks] == j).all() and (np.diff(blocks) > 0).all()
