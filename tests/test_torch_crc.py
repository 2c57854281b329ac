"""CRC / outer-BCH acceptance and the information-set codes against the JAX
package on the CPU.

* The CRC and BCH constructions are bit-identical to the reference's:
  polynomials, check matrices, the attach and check functions, the BCH
  generator, the DVB-S2 parameters, syndromes and ``bch_correct``;
  ``gf2_rref`` / ``gf2_rank`` too.
* ``regular(648)`` has the reference's dimension (328) and information
  set, and its information-set encoder makes codewords.
* The torch path's in-loop CRC latch equals the jnp ``decode_qc`` with
  ``crc="16"`` bit for bit (bits, converged, accepted, iterations), in
  both schedules, and an outer-BCH latch likewise.
* The acceptance wrapper (``ops/crc_accept.py``) around a syndrome-only
  decode equals the latch (retry and full-batch fallback, without early
  exit, small batches), and triage compacts on acceptance
  (tests/test_crc_decode.py's cases).
* ``sim_step`` with a CRC and with the outer BCH counts consistently:
  BASELINE config 1's undetected errors vanish under 1c's CRC.
The CUDA kernels themselves run only on a card (chip_smoke.py)."""
import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import bch as ref_bch
from myldpccppapi_tpu.codes import crc as ref_crc
from myldpccppapi_tpu.codes import gf2 as ref_gf2
from myldpccppapi_tpu.codes.regular import regular as ref_regular
from myldpccppapi_tpu.ops import bp as ref_bp

from myldpccppapi_torch import Decoder, DecoderConfig, Encoder, interop, regular
from myldpccppapi_torch.codes import bch, crc, gf2
from myldpccppapi_torch.codes.encoder import generic_precompute
from myldpccppapi_torch.ops import bp
from myldpccppapi_torch.ops.crc_accept import decode_with_crc_accept
from myldpccppapi_torch.sim import make_decode_fn, sim_step

torch.set_num_threads(1)

ACCEPT_FIELDS = ("bits", "converged", "iterations", "total_iters", "accepted")


@pytest.mark.parametrize("name", sorted(crc.CRC_POLYS))
def test_crc_matches_reference(name):
    assert crc.CRC_POLYS[name] == ref_crc.CRC_POLYS[name]
    k = 100
    np.testing.assert_array_equal(crc.crc_matrix(k, name), ref_crc.crc_matrix(k, name))
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, (6, k), dtype=np.uint8)
    np.testing.assert_array_equal(crc.crc_numpy(u, name), ref_crc.crc_numpy(u, name))
    got = crc.crc_attach_fn(k, name)(torch.from_numpy(u))
    want = np.asarray(ref_crc.crc_attach_fn(k, name)(jnp.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    bad = got.clone()
    bad[::2, 7] ^= 1
    np.testing.assert_array_equal(
        crc.crc_check_fn(k, name)(bad).numpy(),
        np.asarray(ref_crc.crc_check_fn(k, name)(jnp.asarray(bad.numpy()))))
    assert crc.crc_check_fn(k, name)(bad).tolist() == [False, True] * 3


@pytest.mark.parametrize("m,t", [(14, 12), (16, 8), (16, 10), (16, 12)])
def test_bch_construction_matches_reference(m, t):
    assert bch.smallest_primitive_poly(m) == ref_bch.smallest_primitive_poly(m)
    assert bch.bch_generator(m, t) == ref_bch.bch_generator(m, t)
    np.testing.assert_array_equal(bch.bch_matrix(64, m, t), ref_bch.bch_matrix(64, m, t))


def test_bch_params_dvbs2_match_reference():
    for (n, rate) in [*ref_bch._DVBS2_T, (16200, "1/2"), (16200, "8/9")]:
        assert bch.bch_params_dvbs2(n, rate) == ref_bch.bch_params_dvbs2(n, rate)


def test_bch_attach_check_syndromes_and_correct_match_reference():
    m, t, k = 14, 12, 120
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (4, k), dtype=np.uint8)
    cw = bch.bch_attach_fn(k, m, t)(torch.from_numpy(u))
    np.testing.assert_array_equal(
        cw.numpy(), np.asarray(ref_bch.bch_attach_fn(k, m, t)(jnp.asarray(u))))
    assert bch.bch_check_fn(k, m, t)(cw).all()
    words = cw.numpy().copy()
    for r, n_err in enumerate((0, 3, t, t + 4)):  # the last one too many
        words[r, rng.choice(words.shape[1], n_err, replace=False)] ^= 1
    np.testing.assert_array_equal(
        bch.bch_check_fn(k, m, t)(torch.from_numpy(words)).numpy(),
        np.asarray(ref_bch.bch_check_fn(k, m, t)(jnp.asarray(words))))
    np.testing.assert_array_equal(bch.bch_syndromes(words, m, t),
                                  ref_bch.bch_syndromes(words, m, t))
    got, ok = bch.bch_correct(words, m, t)
    want, ref_ok = ref_bch.bch_correct(words, m, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(got[:3], cw.numpy()[:3])  # <= t errors fixed


def test_gf2_rref_and_rank_match_reference():
    rng = np.random.default_rng(2)
    for shape in ((12, 20), (30, 30), (40, 25)):
        m = rng.integers(0, 2, shape).astype(bool)
        m[3] = m[1] ^ m[2]  # rank-deficient
        rref, piv = gf2.gf2_rref(m)
        want_rref, want_piv = ref_gf2.gf2_rref(m)
        np.testing.assert_array_equal(rref, want_rref)
        np.testing.assert_array_equal(piv, want_piv)
        assert gf2.gf2_rank(m) == ref_gf2.gf2_rank(m)


def test_regular_648_matches_reference():
    """tests/test_edgelist.py:80: dimension 328, the reference's
    information set; the information-set encoder makes codewords."""
    mine, theirs = regular(648), ref_regular(648)
    assert (mine.k_info, mine.z, mine.num_blocks) == (328, 108, 18)
    np.testing.assert_array_equal(mine.base, theirs.base)
    np.testing.assert_array_equal(mine.info_cols, theirs.info_cols)
    mats = generic_precompute(mine.h_dense())
    ref_mats = ref.Encoder(theirs).mats
    np.testing.assert_array_equal(mats.w, np.asarray(ref_mats.w))
    np.testing.assert_array_equal(mats.perm, np.asarray(ref_mats.perm))
    u = np.random.default_rng(4).integers(0, 2, (8, 328), dtype=np.uint8)
    cw = Encoder(mine, device="cpu")(torch.from_numpy(u)).numpy()
    assert not mine.syndrome(cw).any()
    np.testing.assert_array_equal(cw[:, mine.info_positions], u)


@pytest.fixture(scope="module")
def wimax12():
    return ref.wimax(576, "1/2")


def _frames(rcode, crc_name, n_frames=4, seed=0):
    """tests/test_crc_decode.py::_frames: clean LLRs of codewords whose info
    blocks carry a valid / a broken CRC (valid LDPC codewords either way)."""
    k_msg = rcode.k_info - crc.CRC_POLYS[crc_name][0]
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (n_frames, k_msg)).astype(np.uint8)
    u_good = crc.crc_attach_fn(k_msg, crc_name)(torch.from_numpy(msg)).numpy()
    u_bad = u_good.copy()
    u_bad[:, 3] ^= 1
    enc = Encoder(interop.code_from_reference(rcode), device="cpu")
    return tuple(((1.0 - 2.0 * enc(torch.from_numpy(u)).numpy()) * 4.0).astype(np.float32)
                 for u in (u_good, u_bad))


def _noisy(rcode, n_frames, snr_db, seed):
    """Random info bits (no CRC: every such frame is rejected) through
    BPSK/AWGN."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (n_frames, rcode.k), dtype=np.uint8)
    c = ref.codes.encode_numpy(ref.Encoder(rcode).mats, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _assert_same(got, want, fields=ACCEPT_FIELDS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_crc_latch_matches_jnp(wimax12, schedule, early_exit):
    """Forged frames (valid codewords, broken CRC) keep decoding to the
    cap; true ones are accepted at once; noisy ones too at a converging
    point (their CRC-less info fails the check)."""
    good, bad = _frames(wimax12, "16")
    llr = np.concatenate([good, bad, _noisy(wimax12, 4, 3.0, 9)])
    kw = dict(schedule=schedule, crc="16", max_iters=8, early_exit=early_exit)
    got = bp.decode_qc(interop.code_from_reference(wimax12), DecoderConfig(**kw),
                       torch.from_numpy(llr))
    want = ref_bp.decode_qc(wimax12, ref.DecoderConfig(**kw), jnp.asarray(llr))
    _assert_same(got, want)
    assert got.accepted[:4].all() and not got.accepted[4:].any()
    assert (got.iterations[:4] == 1).all() and got.converged[:8].all()


def test_outer_bch_latch_matches_jnp():
    rcode = ref.wimax(576, "1/2")
    cfg = dict(outer=("bch", 16, 8), max_iters=6)
    llr = _noisy(rcode, 6, 4.0, 11)
    got = bp.decode_qc(interop.code_from_reference(rcode), DecoderConfig(**cfg),
                       torch.from_numpy(llr))
    want = ref_bp.decode_qc(rcode, ref.DecoderConfig(**cfg), jnp.asarray(llr))
    _assert_same(got, want)
    assert not got.accepted.any()  # random info bits fail the BCH


def _wrapped(code, cfg, llr, cap):
    inner = partial(bp.decode_qc, code, dataclasses.replace(cfg, crc=None))
    retry = partial(bp.decode_qc, code, cfg)
    return decode_with_crc_accept(inner, retry, bp.crc_fail_fn(code, "16"),
                                  torch.from_numpy(llr), cap)


@pytest.mark.parametrize("n_good,n_bad,cap", [(6, 6, 8), (0, 12, 4), (1, 0, 8)])
def test_crc_accept_wrapper_equals_latch(wimax12, n_good, n_bad, cap):
    """Retry of the compacted rejected frames (6 <= cap 8), the full-batch
    fallback (12 > cap 4), nothing rejected; each equal to the latch and
    to the jnp path."""
    good, bad = _frames(wimax12, "16", n_frames=max(n_good, n_bad, 1))
    llr = np.concatenate([good[:n_good], bad[:n_bad]])
    code = interop.code_from_reference(wimax12)
    cfg = DecoderConfig(schedule="layered", crc="16", max_iters=10)
    got = _wrapped(code, cfg, llr, cap)
    _assert_same(got, bp.decode_qc(code, cfg, torch.from_numpy(llr)))
    _assert_same(got, ref_bp.decode_qc(wimax12, ref.DecoderConfig(
        schedule="layered", crc="16", max_iters=10), jnp.asarray(llr)),
        ACCEPT_FIELDS[:3] + ACCEPT_FIELDS[4:])
    assert got.accepted.tolist() == [True] * n_good + [False] * n_bad


def test_crc_accept_wrapper_writes_back_posteriors(wimax12):
    """Soft output through the retry: the retried frames' posteriors are
    the latch's."""
    good, bad = _frames(wimax12, "16", n_frames=3)
    llr = np.concatenate([good, bad, _noisy(wimax12, 2, 3.0, 4)])
    code = interop.code_from_reference(wimax12)
    cfg = DecoderConfig(crc="16", max_iters=6, soft_output=True)
    got = _wrapped(code, cfg, llr, 8)
    want = bp.decode_qc(code, cfg, torch.from_numpy(llr))
    _assert_same(got, want, ACCEPT_FIELDS + ("posteriors",))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_crc_with_triage(wimax12, schedule):
    """Triage compacts on acceptance, so rejected frames get the full
    budget, and merges ``accepted``: equal to one pass and to the
    reference's triage."""
    good, bad = _frames(wimax12, "16")
    llr = np.concatenate([good, bad])
    kw = dict(schedule=schedule, crc="16", max_iters=10, triage_iters=2,
              triage_cap_frac=0.9)
    got = Decoder(interop.code_from_reference(wimax12), DecoderConfig(**kw),
                  device="cpu")(torch.from_numpy(llr))
    single = bp.decode_qc(interop.code_from_reference(wimax12),
                          DecoderConfig(**dict(kw, triage_iters=0)), torch.from_numpy(llr))
    _assert_same(got, single, ("bits", "converged", "iterations", "accepted"))
    want = ref.Decoder(wimax12, ref.DecoderConfig(**kw, implementation="jnp"))(
        jnp.asarray(llr))
    _assert_same(got, want, ("bits", "converged", "iterations", "accepted"))
    assert got.accepted.tolist() == [True] * 4 + [False] * 4


@pytest.mark.parametrize("batch", [1, 3])
def test_crc_small_batches(wimax12, batch):
    good, bad = _frames(wimax12, "16")
    llr = np.concatenate([bad[:1], good])[:batch]
    code = interop.code_from_reference(wimax12)
    cfg = DecoderConfig(crc="16", max_iters=8)
    got = _wrapped(code, cfg, llr, 8)
    assert got.accepted.tolist() == [False] + [True] * (batch - 1)
    _assert_same(got, bp.decode_qc(code, cfg, torch.from_numpy(llr)))


def test_crc_fail_fn_needs_room():
    class Tiny:
        k_info = 16
        info_positions = np.arange(16)

    with pytest.raises(ValueError):
        bp.crc_fail_fn(Tiny(), "24A")
    with pytest.raises(ValueError):
        DecoderConfig(crc="23Z")


def test_sim_step_config_1_and_1c_split():
    """BASELINE config 1's point (regular 648, flooding SP, 2 dB): without
    a CRC some frames converge to a wrong codeword, undetected; config 1c's
    CRC-16 catches every one (the reference's
    test_sim_step_detected_undetected_split)."""
    code = regular(648)
    enc = Encoder(code, device="cpu")
    base = dict(algorithm="sum-product", schedule="flooding")
    stats = {}
    for name, cfg in (("1", DecoderConfig(**base)), ("1c", DecoderConfig(**base, crc="16"))):
        s = sim_step(code, cfg, torch.Generator().manual_seed(1), 2.0, 192, encode_fn=enc,
                     decode_fn=make_decode_fn(code, cfg, device="cpu"))
        stats[name] = {k: int(v) for k, v in s._asdict().items()}
    s0, s1 = stats["1"], stats["1c"]
    assert s0["undetected_errors"] > 0 and s0["crc_rejected"] == 0
    assert s1["undetected_errors"] == 0 and s1["crc_rejected"] > 0
    assert s1["frame_errors"] >= s1["crc_rejected"]
    for s in (s0, s1):
        assert s["frames"] == 192 and s["info_bits"] == 192 * 328
        assert s["frame_errors"] >= s["undetected_errors"]


def test_sim_step_outer_bch_counts():
    """The DVB-S2 leg's flow (dvbs2 16200 r1/2, post-decode BCH): at a clean
    point nothing is rejected; with a tiny iteration budget every frame
    that fails is detected, none accepted wrongly; in the decoder's latch
    (cfg.outer) the counts agree."""
    from myldpccppapi_torch.codes import dvbs2, ira_encode_fn

    code = dvbs2(16200, "1/2")
    m, t, _ = bch.bch_params_dvbs2(16200, "1/2")
    enc = ira_encode_fn(code)
    for snr, iters in ((4.0, 20), (1.0, 2)):
        cfg = DecoderConfig(normalization=0.85, max_iters=iters)
        post = sim_step(code, cfg, torch.Generator().manual_seed(2), snr, 3, encode_fn=enc,
                        decode_fn=make_decode_fn(code, cfg, device="cpu"),
                        outer=("bch", m, t))
        cfg_in = dataclasses.replace(cfg, outer=("bch", m, t))
        latch = sim_step(code, cfg_in, torch.Generator().manual_seed(2), snr, 3,
                         encode_fn=enc, decode_fn=make_decode_fn(code, cfg_in, device="cpu"))
        p, q = ({k: int(v) for k, v in s._asdict().items()} for s in (post, latch))
        assert p["frames"] == q["frames"] == 3
        assert p["undetected_errors"] == q["undetected_errors"] == 0
        if snr == 4.0:
            assert p["frame_errors"] == p["crc_rejected"] == q["frame_errors"] == 0
        else:
            assert p["frame_errors"] == 3 and q["frame_errors"] == 3
