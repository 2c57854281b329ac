"""The edge-list path (ops/bp_edgelist.py) against the JAX package on the
CPU.

* ``build_edge_index`` builds the reference's tables on wimax 576, regular
  (648), the DVB-S2 oracle and a random H whose layers touch columns
  twice.
* ``decode_edgelist`` in f32 min-sum, flooding and layered, is bit-exact
  with the reference's in every field (bits, converged, iterations,
  total_iters, posteriors), at a converging SNR and one where frames hit
  the cap, early exit on and off: on the random H with intra-layer
  collisions (whose posterior adds follow XLA's slot order; the reversed
  order gives other posteriors), rs_ldpc(4, 4, 8) and wimax 576 with a
  layer per block row, and the DVB-S2 16200 oracle with its mod-q layers.
* Sum-product: equal hard outputs at a converging point, posteriors to
  SP_RTOL (torch's exp / log1p are not XLA's).  bf16 soft output: every
  frame converges and the posteriors are bf16 (the reference's
  ``test_edgelist_honors_bf16``).
* CRC and outer-BCH acceptance in the edge list's latch match the
  reference's ``test_crc_decode`` edge-list cases; triage equals a single
  pass; ``Decoder`` dispatch and the reference's refusals.
* Neither the edge-list decode nor the transport de-rate-matching calls
  ``index_add_`` / ``scatter_add_`` (atomics on CUDA)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes.crc import crc_attach_fn as ref_crc_attach_fn
from myldpccppapi_tpu.ops import bp_edgelist as ref_el

from myldpccppapi_torch import Decoder, DecoderConfig, regular, rs_ldpc, wimax
from myldpccppapi_torch.codes import encode_numpy, plan_tb, ru_precompute
from myldpccppapi_torch.codes.bch import bch_attach_fn, bch_matrix
from myldpccppapi_torch.codes.crc import CRC_POLYS, crc_attach_fn
from myldpccppapi_torch.codes.nr_transport import NRTransport
from myldpccppapi_torch.ops import bp_edgelist as el

torch.set_num_threads(1)

ref_dv = importlib.import_module("myldpccppapi_tpu.codes.dvbs2")
dv = importlib.import_module("myldpccppapi_torch.codes.dvbs2")

FIELDS = ("bits", "converged", "iterations", "total_iters")
#: sum-product's posteriors against the reference, relative to max(|x|, 1):
#: torch's exp / log1p are not XLA's, and phi of a nearly cancelled
#: argument magnifies their last-bit differences (3.1e-2 measured on the
#: oracle at 2 dB)
SP_RTOL = 5e-2


def _collision_h(n=120, m=60, deg=6, layers=4, seed=3):
    """A random H (rows of ``deg`` distinct columns) with layers by row
    residue: its ``m / layers`` rows a layer touch many columns twice or
    more, the case whose posterior adds need an order."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([rng.choice(n, deg, replace=False) for _ in range(m)])
    return rows, cols, n, m, np.arange(m) % layers


def _indexes(case):
    """(port EdgeIndex, reference EdgeIndex) of a named case."""
    if case == "collisions":
        args = _collision_h()
        return el.build_edge_index(*args), ref_el.build_edge_index(*args)
    if case == "oracle":
        return dv.dvbs2_oracle(16200, "1/2").edge_index, ref_dv.dvbs2_oracle(16200, "1/2").edge_index
    code = {"wimax": wimax(576, "1/2"), "regular": regular(648),
            "rs_ldpc": rs_ldpc(4, 4, 8)}[case]
    rows, cols = code.h_coo()
    layer = np.arange(code.m) // code.z if hasattr(code, "z") else None
    return (el.build_edge_index(rows, cols, code.n, code.m, layer),
            ref_el.build_edge_index(rows, cols, code.n, code.m, layer))


def _zero_cw_llr(n, batch, snr_db, seed):
    """The all-zero codeword (a codeword of any H) through BPSK/AWGN."""
    rng = np.random.default_rng(seed)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 + sigma * rng.standard_normal((batch, n)).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _assert_equal(got, want, posteriors=True):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if posteriors:
        np.testing.assert_array_equal(got.posteriors.float().numpy(),
                                      np.asarray(want.posteriors, np.float32))


@pytest.mark.parametrize("case", ["wimax", "regular", "oracle", "collisions"])
def test_build_edge_index_matches_reference(case):
    mine, theirs = _indexes(case)
    for f in ("edge_col", "row_edges", "col_edges", "row_layer"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (mine.n, mine.m, mine.num_edges, mine.num_layers) == (
        theirs.n, theirs.m, theirs.num_edges, theirs.num_layers)


def test_collision_case_has_repeated_columns_in_a_layer():
    idx, _ = _indexes("collisions")
    plan = el._plan(idx, torch.device("cpu"))
    assert max(len(lay.passes) for lay in plan.layers) >= 3
    for lay in plan.layers:
        seen = [c.tolist() for _, c in lay.passes]
        for cols in seen:
            assert len(cols) == len(set(cols))  # one write per column a pass
        assert sorted(sum(seen, [])) == sorted(lay.cols[lay.slots].tolist())


#: (case, SNRs: a converging one and one where frames hit the cap, batch)
BITEXACT = {"collisions": ((4.0, 0.5), 12), "rs_ldpc": ((5.0, 1.0), 12),
            "wimax": ((4.0, 1.0), 12), "oracle": ((2.0, 0.8), 8)}


def _case_llr(case, idx, snr, batch, seed):
    if case in ("collisions", "rs_ldpc"):
        return _zero_cw_llr(idx.n, batch, snr, seed)
    rng = np.random.default_rng(seed)
    if case == "wimax":
        code = wimax(576, "1/2")
        c = encode_numpy(ru_precompute(code), rng.integers(0, 2, (batch, code.k), dtype=np.uint8))
    else:
        code = dv.dvbs2_oracle(16200, "1/2")
        c = code.encode_numpy(rng.integers(0, 2, (batch, code.k), dtype=np.uint8))
    sigma = np.float32(10 ** (-snr / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("case", list(BITEXACT))
def test_min_sum_bit_exact_with_reference(case, schedule):
    mine, theirs = _indexes(case)
    snrs, batch = BITEXACT[case]
    for si, snr in enumerate(snrs):
        llr = _case_llr(case, mine, snr, batch, seed=11 + si)
        kws = [dict(normalization=0.8), dict(offset=0.25)]
        if si == 0:
            kws.append(dict(normalization=0.75, early_exit=False))
        for kw in kws:
            kw = dict(schedule=schedule, max_iters=15, soft_output=True, **kw)
            got = el.decode_edgelist(mine, DecoderConfig(**kw), torch.from_numpy(llr))
            want = ref_el.decode_edgelist(theirs, ref.DecoderConfig(**kw), jnp.asarray(llr))
            _assert_equal(got, want)
            if si == 1 and kw.get("normalization") == 0.8:
                # the hard point: some frames run to the cap
                assert int(got.iterations.max()) == 15


def test_posterior_adds_follow_slot_order(monkeypatch):
    """The collision case's layered posteriors equal the reference's only
    with a column's deltas added in slot order: the passes reversed (a
    column's later slot first) give other posteriors."""
    mine, theirs = _indexes("collisions")
    llr = _zero_cw_llr(mine.n, 12, 0.5, seed=12)
    cfg = dict(normalization=0.8, max_iters=15, soft_output=True)
    want = ref_el.decode_edgelist(theirs, ref.DecoderConfig(**cfg), jnp.asarray(llr))
    _assert_equal(el.decode_edgelist(mine, DecoderConfig(**cfg), torch.from_numpy(llr)), want)
    passes = el.column_passes
    monkeypatch.setattr(el, "column_passes", lambda s, c: passes(s, c)[::-1])
    el._plan.cache_clear()
    try:
        got = el.decode_edgelist(mine, DecoderConfig(**cfg), torch.from_numpy(llr))
    finally:
        el._plan.cache_clear()
    assert not np.array_equal(got.posteriors.numpy(), np.asarray(want.posteriors))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_sum_product_hard_outputs_match_reference(schedule):
    mine, theirs = _indexes("oracle")
    llr = _case_llr("oracle", mine, 2.0, 8, seed=13)
    kw = dict(algorithm="sum-product", schedule=schedule, max_iters=20, soft_output=True)
    got = el.decode_edgelist(mine, DecoderConfig(**kw), torch.from_numpy(llr))
    want = ref_el.decode_edgelist(theirs, ref.DecoderConfig(**kw), jnp.asarray(llr))
    assert bool(got.converged.all())
    _assert_equal(got, want, posteriors=False)
    a, b = got.posteriors.numpy(), np.asarray(want.posteriors)
    np.testing.assert_array_equal(a <= 0, b <= 0)
    assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) < SP_RTOL


def test_bf16_soft_output_converges():
    """tests/test_decoder.py::test_edgelist_honors_bf16: wimax 576 r1/2,
    layered NMS alpha 0.75, bf16 messages, soft output."""
    cfg = dict(schedule="layered", normalization=0.75, implementation="edgelist",
               msg_dtype="bfloat16", soft_output=True)
    rng = np.random.default_rng(1)
    llr = rng.normal(4.0, 1.0, (8, 576)).astype(np.float32)
    res = Decoder(wimax(576, "1/2"), DecoderConfig(**cfg), device="cpu")(llr)
    want = ref.Decoder(ref.wimax(576, "1/2"), ref.DecoderConfig(**cfg))(jnp.asarray(llr))
    assert res.posteriors.dtype == torch.bfloat16
    assert bool(res.converged.all()) and bool(np.asarray(want.converged).all())
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal((res.posteriors <= 0).to(torch.uint8).numpy(),
                                  res.bits.numpy())


def _good_bad_llr(code, attach, k_msg, n_frames=4, flip=3, seed=0):
    """tests/test_crc_decode.py::_frames: clean LLRs of codewords whose info
    blocks carry a valid / a broken check field (the bad ones are valid
    LDPC codewords)."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (n_frames, k_msg)).astype(np.int8)
    good = attach(torch.from_numpy(msg)).numpy().astype(np.uint8)
    bad = good.copy()
    bad[:, flip] ^= 1
    mats = ru_precompute(code)
    return [((1.0 - 2.0 * encode_numpy(mats, u)) * 4.0).astype(np.float32)
            for u in (good, bad)]


@pytest.mark.parametrize("check", ["crc", "bch"])
@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_acceptance_latch_matches_reference(check, schedule):
    """test_crc_rejects_wrong_codeword / test_outer_bch_rejects_wrong_codeword
    [edgelist]: a valid codeword with a broken check keeps decoding to the
    cap (converged, not accepted); a good one accepts on the first sweep."""
    code, theirs = wimax(576, "1/2"), ref.wimax(576, "1/2")
    if check == "crc":
        k_msg = code.k_info - CRC_POLYS["16"][0]
        frames = _good_bad_llr(code, crc_attach_fn(k_msg, "16"), k_msg)
        kw = dict(crc="16")
    else:
        m, t = 9, 2
        k_msg = code.k_info - bch_matrix(1, m, t).shape[1]
        frames = _good_bad_llr(code, bch_attach_fn(k_msg, m, t), k_msg, flip=5)
        kw = dict(outer=("bch", m, t))
    cfg = dict(schedule=schedule, implementation="edgelist", max_iters=12, **kw)
    dec = Decoder(code, DecoderConfig(**cfg), device="cpu")
    ref_dec = ref.Decoder(theirs, ref.DecoderConfig(**cfg))
    assert dec.implementation == "edgelist"
    for good, llr in zip((True, False), frames):
        got, want = dec(llr), ref_dec(jnp.asarray(llr))
        _assert_equal(got, want, posteriors=False)
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
        assert bool(got.converged.all())
        assert got.accepted.tolist() == [good] * 4
        assert got.iterations.tolist() == [1 if good else 12] * 4


def test_crc_span_latch_on_the_oracle_matches_reference():
    """CRC24B at a span inside the information block, on the oracle's
    mod-q layers: the latch, accepted and converged (final posterior's
    syndrome or the latch) equal the reference's."""
    code, theirs = dv.dvbs2_oracle(16200, "1/2"), ref_dv.dvbs2_oracle(16200, "1/2")
    span = 4000
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 2, (8, span - 24)).astype(np.int8)
    u = np.concatenate([np.asarray(ref_crc_attach_fn(span - 24, "24B")(jnp.asarray(msg))),
                        rng.integers(0, 2, (8, code.k - span)).astype(np.int8)], axis=1)
    u[4:, 7] ^= 1  # the CRC fails on half the frames
    c = code.encode_numpy(u.astype(np.uint8))
    sigma = np.float32(10 ** (-1.2 / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    llr = (y * np.float32(2 / sigma**2)).astype(np.float32)
    cfg = dict(normalization=0.8, max_iters=12, crc="24B", crc_span=span)
    got = Decoder(code, DecoderConfig(**cfg), device="cpu")(llr)
    want = ref.Decoder(theirs, ref.DecoderConfig(**cfg))(jnp.asarray(llr))
    _assert_equal(got, want, posteriors=False)
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    assert not bool(got.accepted[4:].any())


@pytest.mark.parametrize("snr_db,branch", [(2.4, "retry"), (2.0, "fallback")])
def test_triage_equals_single_pass(snr_db, branch):
    """A 6-sweep fast pass over 32 frames (a straggler buffer of 8), then
    the stragglers, or the whole batch again, at 15 sweeps."""
    code = dv.dvbs2_oracle(16200, "1/2")
    llr = _case_llr("oracle", code.edge_index, snr_db, 32, seed=14)
    cfg = DecoderConfig(normalization=0.8, max_iters=15)
    fast = el.decode_edgelist(code.edge_index, dataclasses.replace(cfg, max_iters=6),
                              torch.from_numpy(llr))
    n_bad = int((~fast.converged).sum())
    assert (0 < n_bad <= 8) if branch == "retry" else n_bad > 8
    dec = Decoder(code, dataclasses.replace(cfg, triage_iters=6), device="cpu")
    single = el.decode_edgelist(code.edge_index, cfg, torch.from_numpy(llr))
    got = dec(llr)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(single, f)), f


def test_decoder_dispatch_and_refusals():
    oracle = dv.dvbs2_oracle(16200, "1/2")
    assert Decoder(oracle, DecoderConfig(), device="cpu").implementation == "edgelist"
    assert DecoderConfig(implementation="edgelist").implementation == "edgelist"
    for code in (wimax(576, "1/2"), rs_ldpc(4, 4, 8)):
        dec = Decoder(code, DecoderConfig(implementation="edgelist"), device="cpu")
        assert dec.implementation == "edgelist"
        assert dec._edge_index().num_layers == code.m_b  # a layer per block row
    assert Decoder(wimax(576, "1/2"), DecoderConfig(), device="cpu").implementation == "torch"
    with pytest.raises(ValueError, match="edge-list"):
        Decoder(oracle, DecoderConfig(implementation="torch"), device="cpu")
    with pytest.raises(TypeError, match="code_from_reference"):
        Decoder(ref.wimax(576, "1/2"), device="cpu")
    # the reference's refusals: SCMS, weights that are not scalars
    with pytest.raises(ValueError, match="SCMS"):
        DecoderConfig(implementation="edgelist", schedule="flooding", self_correction=True)
    with pytest.raises(ValueError, match="SCMS"):
        Decoder(oracle, DecoderConfig(schedule="flooding", self_correction=True), device="cpu")
    with pytest.raises(NotImplementedError, match="scalar"):
        DecoderConfig(implementation="edgelist", normalization=(0.7, 0.8))
    with pytest.raises(NotImplementedError, match="scalar"):
        Decoder(oracle, DecoderConfig(normalization=tuple([0.8] * 25)), device="cpu")
    with pytest.raises(NotImplementedError, match="scalar"):
        DecoderConfig(implementation="edgelist", normalization=((0.7,), (0.8,)))
    with pytest.raises(ValueError, match="triage"):
        Decoder(oracle, device="cpu", soft_output=True, triage_iters=3)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(dv.dvbs2_oracle(16200, "1/2"), DecoderConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NRTransport(plan_tb(200, 960, qm=2))


class _AtenOps(TorchDispatchMode):
    """Records the name of every aten op dispatched (and whether an
    ``index_put`` accumulates)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if "index_put" in name and (kwargs.get("accumulate") or
                                     (len(args) > 3 and args[3])):
            name += "(accumulate)"
        self.names.append(name)
        return func(*args, **kwargs)


def _accumulating(names):
    return [n for n in names
            if n.startswith(("index_add", "scatter_add", "scatter_reduce"))
            or "accumulate" in n]


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_no_atomic_scatter_adds(schedule):
    idx, _ = _indexes("collisions")
    llr = torch.from_numpy(_zero_cw_llr(idx.n, 4, 1.0, seed=15))
    with _AtenOps() as ops:
        el.decode_edgelist(idx, DecoderConfig(schedule=schedule, max_iters=3,
                                              early_exit=False, soft_output=True), llr)
    assert ops.names and not _accumulating(ops.names)
    assert any(n.startswith("index_put") for n in ops.names)  # the passes' writes
    t = NRTransport(plan_tb(200, 2880, qm=2, rv=2), device="cpu")  # repetition
    with _AtenOps() as ops:
        t.llr_to_blocks(torch.ones((2, t.fmt.g)))
    assert ops.names and not _accumulating(ops.names)
