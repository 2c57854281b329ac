"""BICM-ID and the DVB-S2 bit interleaver against the JAX package on the CPU.

* ``n_outer=0`` is the one-shot receive chain.
* Stage by stage: the reference's demapped LLRs through the port's soft
  decoder give the reference's bits, iterations and posteriors exactly.
* The whole loop on Gray 16QAM with max-log demapping uses real arithmetic
  only (the separable demap, min-sum): bit-exact with the reference's loop
  end to end, every intermediate posterior included.
* On 8PSK (natural labels) and 16APSK the demap's metric is a complex
  ``abs``, which torch rounds otherwise than XLA (tests/
  test_torch_modulation.py), so the loop is held at a converging point to
  equal bits and converged flags, its posteriors to the demap's tolerance
  scaled by the LLRs' size; iterations may differ by the sweeps a
  last-ulp difference changes.
* The EN 302 307 bit interleaver equals the reference's and round-trips,
  and feedback crosses it both ways.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import wimax as ref_wimax
from myldpccppapi_tpu.ops import bicm_id as ref_bicm
from myldpccppapi_tpu.ops import modulation as RM

from myldpccppapi_torch import (
    Decoder,
    DecoderConfig,
    bicm_id_receive,
    interop,
    make_bicm_id_receive,
    wimax,
)
from myldpccppapi_torch.ops import modulation as M

torch.set_num_threads(1)

ref_dv = importlib.import_module("myldpccppapi_tpu.codes.dvbs2")
dv = importlib.import_module("myldpccppapi_torch.codes.dvbs2")

CFG = dict(normalization=0.75, max_iters=15)
FIELDS = ("bits", "converged", "iterations", "total_iters")


def _natural_8psk(mod_cls, bits_of):
    """8PSK with natural-binary ring labels (non-Gray: the labeling that
    BICM-ID pays off on; benchmarks/bicm_id_bench.py)."""
    return mod_cls("8psk_nat",
                   np.exp(1j * (2 * np.pi * np.arange(8) / 8 + np.pi / 8)).astype(np.complex64),
                   bits_of(np.arange(8), 3))


def _mods(name):
    """(port's, reference's) constellation of a case name."""
    if name == "8psk_nat":
        return _natural_8psk(M.Modulation, M._bits_of), _natural_8psk(RM.Modulation, RM._bits_of)
    return M.make_modulation(name), RM.make_modulation(name)


def _received(mod, batch, sigma, seed):
    """Symbols of random wimax 576 r1/2 codewords (the reference encoder,
    NumPy draws) through complex AWGN with per-component ``sigma``."""
    rcode = ref_wimax(576, "1/2")
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, rcode.k), dtype=np.uint8)
    cw = np.asarray(ref.Encoder(rcode)(jnp.asarray(u))).astype(np.uint8)
    m = mod.bits_per_symbol
    y = mod.lut()[(cw.reshape(batch, -1, m).astype(np.int64) << np.arange(m)).sum(-1)]
    y = (y + sigma * (rng.standard_normal(y.shape)
                      + 1j * rng.standard_normal(y.shape))).astype(np.complex64)
    return cw, y, np.float32(2 * sigma * sigma)


def _equal(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_zero_outer_equals_the_one_shot_chain():
    """Gray 16QAM, max-log: real arithmetic only, so the reference's
    n_outer=0 loop is matched exactly too."""
    code = wimax(576, "1/2")
    mod, rmod = _mods("16qam")
    _, y, n0 = _received(mod, 16, 0.32, seed=1)
    got = make_bicm_id_receive(code, DecoderConfig(**CFG), mod, n_outer=0,
                               device="cpu")(torch.from_numpy(y), n0)
    one_shot = Decoder(code, DecoderConfig(**CFG), device="cpu")(
        M.demap_llr(torch.from_numpy(y), n0, mod))
    _equal(got, one_shot)
    want = ref_bicm.make_bicm_id_receive(ref_wimax(576, "1/2"), ref.DecoderConfig(**CFG),
                                         rmod, n_outer=0)(jnp.asarray(y), n0)
    _equal(got, want)
    assert 0 < got.converged.sum() < 16  # a point with stragglers


def test_soft_decode_of_the_reference_demap_is_bit_exact():
    """Stage-wise pin: the reference's demapped LLRs through the port's soft
    decoder (the feedback pass) equal the reference's soft decode, the
    latched posteriors of every frame included."""
    mod, rmod = _mods("8psk_nat")
    _, y, n0 = _received(mod, 16, 0.3, seed=2)
    llr = np.array(RM.demap_llr(jnp.asarray(y), n0, rmod))
    cfg = dict(CFG, soft_output=True)
    got = Decoder(wimax(576, "1/2"), DecoderConfig(**cfg), device="cpu")(llr)
    want = ref.Decoder(ref_wimax(576, "1/2"), ref.DecoderConfig(**cfg))(jnp.asarray(llr))
    _equal(got, want, FIELDS + ("posteriors",))
    assert 0 < got.converged.sum() < 16


def _loop_stages(receive_parts, y, n0, n_outer):
    """Run the BICM-ID loop of one package stage by stage: returns every
    intermediate (APPs, posteriors, priors, decoder inputs) and the last
    decode.  ``receive_parts`` = (demap, soft decode, last decode, to-numpy)."""
    demap, soft, last, arr = receive_parts
    stages = []
    app = demap(y, n0, None)
    llr_in = app
    stages.append(arr(app))
    for _ in range(n_outer):
        res = soft(llr_in)
        stages.append(arr(res.posteriors))
        prior = res.posteriors - llr_in
        app = demap(y, n0, prior)
        llr_in = app - prior
        stages += [arr(app), arr(llr_in)]
    return stages, last(llr_in)


@pytest.mark.parametrize("name,sigma,exact", [
    ("16qam", 0.32, True),
    ("8psk_nat", 0.26, False),
    ("16apsk", 0.24, False),
])
def test_loop_matches_reference(name, sigma, exact):
    code, rcode = wimax(576, "1/2"), ref_wimax(576, "1/2")
    mod, rmod = _mods(name)
    cw, y, n0 = _received(mod, 16, sigma, seed=1)
    cfg = DecoderConfig(**CFG)
    rcfg = ref.DecoderConfig(**CFG)
    port = (lambda y, n0, p: M.demap_llr(y, n0, mod, prior=p),
            Decoder(code, DecoderConfig(soft_output=True, **CFG), device="cpu"),
            Decoder(code, cfg, device="cpu"), lambda x: x.numpy())
    theirs = (lambda y, n0, p: RM.demap_llr(y, n0, rmod, prior=p),
              ref.Decoder(rcode, ref.DecoderConfig(soft_output=True, **CFG)),
              ref.Decoder(rcode, rcfg), np.asarray)
    mine, got = _loop_stages(port, torch.from_numpy(y), n0, 2)
    want_stages, want = _loop_stages(theirs, jnp.asarray(y), n0, 2)
    # the factory runs the same loop
    _equal(make_bicm_id_receive(code, cfg, mod, n_outer=2, device="cpu")(
        torch.from_numpy(y), n0), got)
    for a, b in zip(mine, want_stages):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            # the demap's relative tolerance on the stage's LLR scale
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    conv = got.converged.numpy()
    if exact:
        _equal(got, want)
        assert 0 < conv.sum() < len(conv)  # the loop's stragglers too
    else:
        for f in ("bits", "converged"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        d_it = np.abs(got.iterations.numpy() - np.asarray(want.iterations))
        assert d_it.max() <= 1
        assert conv.all()  # a converging point: the loop recovers all
    np.testing.assert_array_equal(got.bits.numpy()[conv], cw[conv])


def test_loop_gains_on_a_non_gray_labeling():
    """At a noisy point on natural-label 8PSK, two exchanges converge more
    frames than the one-shot chain."""
    code = wimax(576, "1/2")
    mod, _ = _mods("8psk_nat")
    _, y, n0 = _received(mod, 16, 0.32, seed=4)
    cfg = DecoderConfig(normalization=0.75, max_iters=20)
    conv = [int(bicm_id_receive(code, cfg, torch.from_numpy(y), n0, mod, n_outer=n,
                                device="cpu").converged.sum()) for n in (0, 2)]
    assert conv[0] < conv[1]


def test_receive_refuses_preset_soft_output_and_negative_outer():
    code = wimax(576, "1/2")
    with pytest.raises(ValueError, match="soft_output"):
        make_bicm_id_receive(code, DecoderConfig(soft_output=True), M.qpsk(), device="cpu")
    with pytest.raises(ValueError, match="n_outer"):
        make_bicm_id_receive(code, DecoderConfig(), M.qpsk(), n_outer=-1, device="cpu")


# -- the interleaver -----------------------------------------------------------

@pytest.mark.parametrize("mod_name,col_order", [("8psk", None), ("16apsk", None),
                                                ("32apsk", None), ("8psk", (2, 1, 0))])
def test_bit_interleaver_matches_reference_and_round_trips(mod_name, col_order):
    nc = dv.BIT_INTERLEAVER_COLS[mod_name]
    assert dv.BIT_INTERLEAVER_COLS == ref_dv.BIT_INTERLEAVER_COLS
    x = np.random.default_rng(nc).standard_normal((2, 16200)).astype(np.float32)
    il = dv.bit_interleave(torch.from_numpy(x), nc, col_order)
    np.testing.assert_array_equal(
        il.numpy(), np.asarray(ref_dv.bit_interleave(jnp.asarray(x), nc, col_order)))
    de = dv.bit_deinterleave(torch.from_numpy(x), nc, col_order)
    np.testing.assert_array_equal(
        de.numpy(), np.asarray(ref_dv.bit_deinterleave(jnp.asarray(x), nc, col_order)))
    np.testing.assert_array_equal(dv.bit_deinterleave(il, nc, col_order).numpy(), x)
    # each symbol takes one bit from each of the nc spans of the frame
    pos = dv.bit_interleave(torch.arange(16200), nc, col_order).reshape(-1, nc)
    assert sorted((pos[0] // (16200 // nc)).tolist()) == list(range(nc))


def test_interleaver_refusals():
    with pytest.raises(ValueError, match="divisible"):
        dv.bit_interleave(torch.zeros(10), 3)
    with pytest.raises(ValueError, match="permute"):
        dv.bit_deinterleave(torch.zeros(12), 3, col_order=(0, 0, 1))


def test_feedback_crosses_the_interleaver_both_ways():
    """With the EN 302 307 interleaver as the hook pair, n_outer=0 equals
    the one-shot deinterleaved decode, and a two-exchange loop runs and
    equals the reference's loop with the same hooks."""
    code = wimax(576, "1/2")
    mod, rmod = _mods("8psk")
    nc = dv.BIT_INTERLEAVER_COLS["8psk"]
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (4, code.k), dtype=np.uint8)
    cw = np.asarray(ref.Encoder(ref_wimax(576, "1/2"))(jnp.asarray(u))).astype(np.uint8)
    tx = dv.bit_interleave(torch.from_numpy(cw), nc)
    y = M.modulate(tx, mod).numpy()
    y = (y + 0.25 * (rng.standard_normal(y.shape)
                     + 1j * rng.standard_normal(y.shape))).astype(np.complex64)
    n0 = np.float32(0.125)
    cfg = DecoderConfig(normalization=0.75, max_iters=12)
    hooks = dict(deinterleave=lambda x: dv.bit_deinterleave(x, nc),
                 interleave=lambda x: dv.bit_interleave(x, nc))
    rx0 = make_bicm_id_receive(code, cfg, mod, n_outer=0, device="cpu", **hooks)
    one_shot = Decoder(code, cfg, device="cpu")(
        dv.bit_deinterleave(M.demap_llr(torch.from_numpy(y), n0, mod), nc))
    _equal(rx0(torch.from_numpy(y), n0), one_shot)
    got = make_bicm_id_receive(code, cfg, mod, n_outer=2, device="cpu", **hooks)(
        torch.from_numpy(y), n0)
    want = ref_bicm.make_bicm_id_receive(
        ref_wimax(576, "1/2"), ref.DecoderConfig(normalization=0.75, max_iters=12),
        rmod, n_outer=2, deinterleave=lambda x: ref_dv.bit_deinterleave(x, nc),
        interleave=lambda x: ref_dv.bit_interleave(x, nc))(jnp.asarray(y), n0)
    assert got.converged.all()  # a converging point
    np.testing.assert_array_equal(got.bits.numpy(), cw)
    for f in ("bits", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_interop_modulation_through_both_loops():
    """A reference constellation carried across decodes alike in both
    packages' one-shot chains."""
    rmod = RM.make_modulation("16apsk", "3/4")
    mod = interop.modulation_from_reference(rmod)
    _, y, n0 = _received(mod, 4, 0.12, seed=6)
    got = M.demap_llr(torch.from_numpy(y), n0, mod).numpy()
    want = np.asarray(RM.demap_llr(jnp.asarray(y), n0, rmod))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got < 0, want < 0)
