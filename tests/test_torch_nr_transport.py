"""The TS 38.212 transport-block chain (``codes/nr_transport.py``) against
the JAX package on the CPU.

* ``plan_tb`` gives the reference's ``TBFormat`` over a grid of (A, G, BG,
  Qm, rv), and ``select_base_graph``, the §5.2.2 K_b and lifting rules,
  the §5.4.2.2 interleavers and the circular-buffer selection runs are
  equal to the reference's.
* ``NRTransport.encode`` gives the reference's bits for the same payload;
  ``llr_to_blocks`` its decoder inputs; ``receive`` equals the reference's
  ``NRTransport.receive`` in every ``TBResult`` field on small BG2 formats:
  one block, two blocks with CRC24B, two with a padded last block, and rv2
  with repetition (noisy LLRs, batch 4).
* Garbage LLRs are flagged (no ``tb_ok``), a wrong code block fails its
  CRC24B, and the default device raises without CUDA.
On the card, chip_smoke.py phase 4o drives BASELINE config 4t."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myldpccppapi_tpu.codes import nr_transport as ref_nt

from myldpccppapi_torch.codes import nr_transport as nt
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

TB_FIELDS = ("payload", "tb_ok", "tb_crc_ok", "cb_ok", "converged", "iterations")

#: small BG2 formats: (name, plan_tb arguments)
FORMATS = {
    "single": ((200, 960), dict(qm=2)),
    "segmented": ((3900, 8000), dict(bg=2, qm=2)),
    "padded": ((3901, 8000), dict(bg=2, qm=2)),
    "rv2 repetition": ((200, 2880), dict(qm=2, rv=2)),
}


@pytest.fixture(scope="module")
def transports():
    """name -> (format, port transport, reference transport)."""
    out = {}
    for name, (args, kw) in FORMATS.items():
        fmt = nt.plan_tb(*args, **kw)
        out[name] = (fmt, nt.NRTransport(fmt, device="cpu"),
                     ref_nt.NRTransport(ref_nt.plan_tb(*args, **kw)))
    return out


def test_select_base_graph_and_lifting_match_reference():
    for a, rate in itertools.product((100, 292, 293, 1000, 3824, 3825, 20000),
                                     (0.2, 0.25, 0.5, 0.67, 0.7, 0.9)):
        assert nt.select_base_graph(a, rate) == ref_nt.select_base_graph(a, rate)
    for bg, b in itertools.product((1, 2), (100, 192, 193, 560, 561, 640, 641, 9000)):
        assert nt._kb(bg, b) == ref_nt._kb(bg, b)
    for k_min, kb in itertools.product((20, 500, 1974, 6699, 8448), (6, 8, 10, 22)):
        if k_min <= 384 * kb:
            assert nt._min_lifting(k_min, kb) == ref_nt._min_lifting(k_min, kb)
    with pytest.raises(ValueError):
        nt._min_lifting(384 * 22 + 1, 22)
    assert nt._ALL_Z == ref_nt._ALL_Z
    assert (nt.KCB, nt.FILLER_LLR, nt.TB_CRC16_MAX_A) == (
        ref_nt.KCB, ref_nt.FILLER_LLR, ref_nt.TB_CRC16_MAX_A)


PLAN_GRID = [
    (a, g, bg, qm, rv)
    for a in (100, 200, 1000, 3824, 3825, 3900, 3901, 16000, 20000)
    for g, qm in ((2 * a + 960, 2), (3 * a + 240, 4), (2 * a + 1200, 6))
    for bg in (None, 1, 2)
    for rv in (0, 2)
    if g % qm == 0 and not (a > 8000 and bg == 2)
]


@pytest.mark.parametrize("a,g,bg,qm,rv", PLAN_GRID[::3] + [(20000, 40000, None, 2, 0)])
def test_plan_tb_matches_reference(a, g, bg, qm, rv):
    mine = nt.plan_tb(a, g, bg=bg, qm=qm, rv=rv)
    theirs = ref_nt.plan_tb(a, g, bg=bg, qm=qm, rv=rv)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for p in ("n_cb", "tb_crc_len", "cb_crc_len", "b", "data_per_block"):
        assert getattr(mine, p) == getattr(theirs, p), p
    assert mine.describe() == theirs.describe()


def test_config_4t_format():
    """BASELINE config 4t (benchmarks/run_baseline.py:883-929): C = 3, K' =
    6699, Z = 320."""
    fmt = nt.plan_tb(20000, 40000, qm=2)
    assert (fmt.bg, fmt.c, fmt.k_prime, fmt.z, fmt.cb_crc, fmt.tb_crc) == (
        1, 3, 6699, 320, "24B", "24A")


def test_plan_tb_rejects_bad_arguments():
    for args, kw in (((1000, 3001), dict(qm=2)), ((0, 100), {}), ((100, 400), dict(bg=3))):
        with pytest.raises(ValueError):
            nt.plan_tb(*args, **kw)
        with pytest.raises(ValueError):
            ref_nt.plan_tb(*args, **kw)


@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_interleavers_match_reference(qm):
    rng = np.random.default_rng(qm)
    e = rng.standard_normal((3, 24 * qm)).astype(np.float32)
    got = nt.interleave_bits(torch.from_numpy(e), qm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_nt.interleave_bits(jnp.asarray(e), qm)))
    back = nt.deinterleave_llr(got, qm)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_nt.deinterleave_llr(jnp.asarray(got.numpy()), qm)))
    np.testing.assert_array_equal(back.numpy(), e)


@pytest.mark.parametrize("n_cb,fs,fe,k0,e", [
    (10, 3, 5, 8, 12), (8, 0, 0, 2, 8), (10, 2, 8, 4, 4), (2200, 1000, 1200, 1100, 5000),
    (10400, 1774, 2000, 0, 4000)])
def test_selection_runs_match_reference(n_cb, fs, fe, k0, e):
    assert nt._selection_runs(n_cb, fs, fe, k0, e) == ref_nt._selection_runs(n_cb, fs, fe, k0, e)


def _payload_llr(fmt, theirs, batch, seed, noise):
    """A payload, the reference's encode of it, and noisy BPSK LLRs."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, size=(batch, fmt.a), dtype=np.int64)
    tx = np.asarray(theirs.encode(jnp.asarray(payload)))
    llr = (1.0 - 2.0 * tx.astype(np.float32)) * np.float32(2.0)
    llr = llr + rng.normal(0, noise, llr.shape).astype(np.float32)
    return payload, tx, llr.astype(np.float32)


@pytest.mark.parametrize("name", list(FORMATS))
def test_encode_and_receive_match_reference(transports, name):
    fmt, mine, theirs = transports[name]
    payload, tx, llr = _payload_llr(fmt, theirs, 4, seed=len(name), noise=1.2)
    got_tx = mine.encode(torch.from_numpy(payload))
    assert got_tx.dtype == torch.int8 and got_tx.shape == (4, fmt.g)
    np.testing.assert_array_equal(got_tx.numpy(), tx)
    np.testing.assert_array_equal(
        mine.segment(payload).numpy(), np.asarray(theirs.segment(jnp.asarray(payload))))
    np.testing.assert_array_equal(
        mine.llr_to_blocks(torch.from_numpy(llr)).numpy(),
        np.asarray(theirs.llr_to_blocks(jnp.asarray(llr))))
    got = mine.receive(llr)
    want = theirs.receive(jnp.asarray(llr))
    for f in TB_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert got.payload.dtype == torch.uint8
    assert bool(got.tb_ok.all())  # a decodable point: the chain is whole
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    if fmt.cb_crc:
        assert mine.decoder.config.crc == "24B"
        assert mine.decoder.config.crc_span == fmt.k_prime
    if name == "rv2 repetition":
        assert fmt.e_r[0] > fmt.n_cb - fmt.f


def test_garbage_and_wrong_block_flagged(transports):
    """One batch of four (the shape the reference compiled for): two frames
    of garbage LLRs, one whose second code block's segment is erased (its
    CRC24B fails, the first block's passes), one clean; every field equal
    to the reference's."""
    fmt, mine, theirs = transports["segmented"]
    rng = np.random.default_rng(11)
    payload, _, llr = _payload_llr(fmt, theirs, 4, seed=13, noise=0.0)
    llr[:2] = rng.normal(0, 1, size=(2, fmt.g))
    llr[2, fmt.e_r[0]:] = rng.normal(0, 0.1, size=fmt.g - fmt.e_r[0])
    got, want = mine.receive(llr), theirs.receive(jnp.asarray(llr))
    for f in TB_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.tb_ok.tolist() == [False, False, False, True]
    assert got.cb_ok[2].tolist() == [True, False]
    np.testing.assert_array_equal(got.payload[3].numpy(), payload[3])


def test_custom_config_keeps_the_cb_crc_recheck(transports):
    """A decoder config with another acceptance check: cb_ok is still the
    decoder's acceptance AND the code block's CRC24B (the post-decode
    recheck); without any, the transport adds CRC24B at span K'."""
    fmt, _, theirs = transports["segmented"]
    cfg = DecoderConfig(normalization=0.75, max_iters=20)
    assert nt.NRTransport(fmt, decoder_config=cfg, device="cpu").decoder.config.crc_span == fmt.k_prime
    mine = nt.NRTransport(fmt, decoder_config=dataclasses.replace(cfg, crc="16", crc_span=100),
                          device="cpu")
    assert mine.decoder.config.crc == "16"
    _, _, llr = _payload_llr(fmt, theirs, 4, seed=17, noise=1.0)
    llr[1, fmt.e_r[0]:] = 0.5  # a block that converges to a wrong codeword or not at all
    got = mine.receive(llr)
    res = mine.decoder(mine.llr_to_blocks(torch.from_numpy(llr)).reshape(4 * fmt.c, -1))
    info = res.bits[:, : fmt.k_prime].to(torch.int8)
    want = res.ok & mine._cb_check(info)
    np.testing.assert_array_equal(got.cb_ok.reshape(-1).numpy(), want.numpy())
    assert not bool(got.tb_ok[1])
