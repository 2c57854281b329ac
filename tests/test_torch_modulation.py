"""The modulation layer against the JAX package on the CPU.

* Every constellation of ``MODULATIONS`` and every APSK ring-ratio row has
  the reference's points, labels and PAM alphabet, exactly (the quasi-Gray
  label search included); ``modulate`` gives the same symbols.
* ``demap_llr`` (max-log and exact, with and without priors, the separable
  QAM path and the full one) is held against the reference's on the same
  NumPy symbols.  Separable max-log QAM uses real arithmetic only and is
  bit-exact.  The other paths agree to ``RTOL``/``ATOL``: PSK/APSK take
  the metric ``|y - x|^2`` of a complex difference, and torch's complex
  ``abs`` rounds otherwise than XLA's (they differ on about 40% of random
  symbols, by an ulp or two); the exact demap's ``logaddexp`` is torch's
  ``exp``/``log1p``, not XLA's.  Measured: relative differences up to
  2e-6 of max(|LLR|, 1).
* ``sim_step`` and the CLI ``waterfall`` run the modulation branch.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myldpccppapi_tpu.ops import modulation as RM

from myldpccppapi_torch import Decoder, DecoderConfig, Encoder, cli, interop, wimax
from myldpccppapi_torch.ops import modulation as M
from myldpccppapi_torch.ops.channel import sigma_from_snr_db
from myldpccppapi_torch.sim import sim_step

torch.set_num_threads(1)

ALL_MODS = sorted(M.MODULATIONS)
SEPARABLE = ("qpsk", "16qam", "64qam", "256qam")
#: the tolerance of every demap path but separable max-log (module
#: docstring): complex abs and logaddexp round otherwise than XLA's
RTOL = ATOL = 1e-5


def _same_modulation(mine, theirs):
    assert mine.name == theirs.name
    np.testing.assert_array_equal(mine.points, theirs.points)
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    assert (mine.pam is None) == (theirs.pam is None)
    if mine.pam is not None:
        for a, b in zip(mine.pam, theirs.pam):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("name", ALL_MODS)
def test_constellations_match_reference(name):
    _same_modulation(M.make_modulation(name), RM.make_modulation(name))
    np.testing.assert_array_equal(M.make_modulation(name).lut(),
                                  RM.make_modulation(name).lut())


@pytest.mark.parametrize("name,rate", [("16apsk", r) for r in M.APSK16_GAMMA]
                         + [("32apsk", r) for r in M.APSK32_GAMMA])
def test_apsk_rate_rows_match_reference(name, rate):
    """Each ring ratio of EN 302 307 Tables 9/10 with its own quasi-Gray
    label search."""
    assert M.APSK16_GAMMA == RM.APSK16_GAMMA and M.APSK32_GAMMA == RM.APSK32_GAMMA
    _same_modulation(M.make_modulation(name, rate), RM.make_modulation(name, rate))


def test_modulation_validation_and_unknown_names():
    with pytest.raises(ValueError, match="permutation"):
        M.Modulation("bad", np.array([1, -1], np.complex64), np.array([[0], [0]]))
    with pytest.raises(ValueError, match="energy"):
        M.Modulation("bad", np.array([2, -2], np.complex64), np.array([[0], [1]]))
    with pytest.raises(ValueError, match="unknown modulation"):
        M.make_modulation("1024qam")
    with pytest.raises(ValueError, match="divisible"):
        M.modulate(torch.zeros((4, 16), dtype=torch.uint8), M.psk8())


@pytest.mark.parametrize("name", ALL_MODS)
def test_modulate_matches_reference(name):
    mod = M.make_modulation(name)
    bits = np.random.default_rng(1).integers(0, 2, (3, 24 * mod.bits_per_symbol),
                                             dtype=np.uint8)
    got = M.modulate(torch.from_numpy(bits), mod)
    assert got.dtype == torch.complex64 and got.shape == (3, 24)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RM.modulate(jnp.asarray(bits), RM.make_modulation(name))))


def _received(name, seed, symbols=96, batch=4, sigma=0.3):
    """Noisy symbols of random bits and per-bit priors, from NumPy."""
    rng = np.random.default_rng(seed)
    mod = M.make_modulation(name)
    bits = rng.integers(0, 2, (batch, symbols * mod.bits_per_symbol), dtype=np.uint8)
    y = mod.lut()[(bits.reshape(batch, symbols, -1).astype(np.int64)
                   << np.arange(mod.bits_per_symbol)).sum(-1)]
    y = (y + sigma * (rng.standard_normal(y.shape)
                      + 1j * rng.standard_normal(y.shape))).astype(np.complex64)
    prior = rng.normal(scale=2.0, size=bits.shape).astype(np.float32)
    return y, prior


@pytest.mark.parametrize("with_prior", [False, True])
@pytest.mark.parametrize("method", ["maxlog", "exact"])
@pytest.mark.parametrize("name", ALL_MODS)
def test_demap_matches_reference(name, method, with_prior):
    y, prior = _received(name, seed=len(name))
    pri = prior if with_prior else None
    got = M.demap_llr(torch.from_numpy(y), 0.18, M.make_modulation(name), method,
                      None if pri is None else torch.from_numpy(pri)).numpy()
    want = np.asarray(RM.demap_llr(jnp.asarray(y), 0.18, RM.make_modulation(name),
                                   method, None if pri is None else jnp.asarray(pri)))
    assert got.dtype == np.float32 and got.shape == want.shape == prior.shape
    if method == "maxlog" and name in SEPARABLE:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["maxlog", "exact"])
@pytest.mark.parametrize("name", SEPARABLE)
def test_separable_demap_against_the_full_one(name, method):
    """The per-axis PAM demap equals the full-constellation loop of both
    packages to float tolerance (the reference's own test's bound), and the
    full loop agrees with the reference's full loop."""
    y, prior = _received(name, seed=7)
    mod = M.make_modulation(name)
    full, rfull = dataclasses.replace(mod, pam=None), dataclasses.replace(
        RM.make_modulation(name), pam=None)
    for pri in (None, prior):
        p_t = None if pri is None else torch.from_numpy(pri)
        sep = M.demap_llr(torch.from_numpy(y), 0.4, mod, method, p_t).numpy()
        whole = M.demap_llr(torch.from_numpy(y), 0.4, full, method, p_t).numpy()
        rwhole = np.asarray(RM.demap_llr(jnp.asarray(y), 0.4, rfull, method,
                                         None if pri is None else jnp.asarray(pri)))
        np.testing.assert_allclose(sep, whole, rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(whole, rwhole, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ALL_MODS)
def test_demap_roundtrip_low_noise(name):
    mod = M.make_modulation(name)
    bits = np.random.default_rng(2).integers(0, 2, (3, 40 * mod.bits_per_symbol),
                                             dtype=np.uint8)
    for method in ("maxlog", "exact"):
        llr = M.demap_llr(M.modulate(torch.from_numpy(bits), mod), 1e-3, mod, method)
        np.testing.assert_array_equal((llr < 0).numpy().astype(np.uint8), bits)


def test_demap_refuses_unknown_method():
    with pytest.raises(ValueError, match="maxlog"):
        M.demap_llr(torch.zeros(4, dtype=torch.complex64), 1.0, M.qpsk(), "mmse")


@pytest.mark.parametrize("name", ["8psk", "16apsk", "64qam"])
def test_interop_carries_modulations(name):
    theirs = RM.make_modulation(name, "3/4")
    _same_modulation(interop.modulation_from_reference(theirs), theirs)
    # a normative label table given to the reference goes through alike
    labels = RM._bits_of(np.arange(8)[::-1].copy(), 3)
    custom = RM.psk8(labels=labels)
    carried = interop.modulation_from_reference(custom)
    _same_modulation(carried, custom)
    _same_modulation(M.psk8(labels=labels), custom)


# -- the simulation and the CLI ------------------------------------------------

@pytest.mark.parametrize("name,snr_db", [("qpsk", 7.0), ("16qam", 14.0),
                                         ("16apsk", 15.0), ("8psk", 12.0)])
def test_sim_step_decodes_clean_frames_through_the_demapper(name, snr_db):
    code = wimax(576, "1/2")
    cfg = DecoderConfig(normalization=0.75, max_iters=30)
    gen = torch.Generator().manual_seed(5)
    stats = sim_step(code, cfg, gen, snr_db, 8, mod=M.make_modulation(name))
    got = {k: int(v) for k, v in stats._asdict().items()}
    assert got["frames"] == 8 and got["info_bits"] == 8 * code.k
    assert got["frame_errors"] == got["bit_errors"] == got["unconverged"] == 0
    assert 0 < got["iterations"] <= 8 * 30


def test_sim_step_modulation_branch_draws_in_order():
    """The generator gives the info bits, then [batch, S, 2] normal noise
    (real, imaginary); n0 = 2 sigma^2: the step equals the chain built by
    hand from the same draws."""
    code = wimax(576, "1/2")
    cfg = DecoderConfig(normalization=0.75, max_iters=20)
    mod = M.make_modulation("16qam")
    stats = sim_step(code, cfg, torch.Generator().manual_seed(11), 9.0, 16, mod=mod)
    gen = torch.Generator().manual_seed(11)
    u = torch.randint(0, 2, (16, code.k), generator=gen, dtype=torch.uint8)
    sym = M.modulate(Encoder(code, device="cpu")(u), mod)
    noise = torch.randn(sym.shape + (2,), generator=gen)
    sigma = sigma_from_snr_db(9.0)
    y = sym + sigma * torch.complex(noise[..., 0], noise[..., 1])
    res = Decoder(code, cfg, device="cpu")(M.demap_llr(y, 2 * sigma * sigma, mod))
    assert int(stats.unconverged) == int((~res.converged).sum()) > 0  # noisy
    assert int(stats.iterations) == int(res.iterations.sum())
    bit_err = (res.bits[:, :code.k] != u).sum(dim=1)
    assert int(stats.bit_errors) == int(bit_err.sum())
    assert int(stats.frame_errors) == int((bit_err > 0).sum())


def test_cli_waterfall_with_modulation(tmp_path, capsys):
    ck = tmp_path / "ck.json"
    argv = ["waterfall", "--family", "wimax", "--n", "576", "--rate", "1/2",
            "--snr=8,11", "--batch", "8", "--target-errors", "4",
            "--max-frames", "16", "--max-iters", "10", "--normalization", "0.75",
            "--mod", "16qam", "--checkpoint", str(ck), "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["snr=+8.00", "snr=+11.00"]
    assert cli.main(argv) == 0  # resumed from the checkpoint
    assert capsys.readouterr().out.strip().splitlines() == lines
    # the fingerprint covers the constellation and the demapper: another
    # is another campaign, which starts afresh
    fp = json.loads(ck.read_text())["fingerprint"]
    assert cli.main([*argv, "--demap", "exact"]) == 0
    capsys.readouterr()
    assert json.loads(ck.read_text())["fingerprint"] != fp


@pytest.mark.parametrize("argv,match", [
    (["--mod", "8psk", "--n", "576", "--rate", "2/3A"], None),
    (["--mod", "32apsk", "--n", "576"], "divisible"),
    (["--id-outer", "2"], "needs --mod"),
    (["--crc", "16"], None),
])
def test_cli_waterfall_modulation_checks(argv, match, tmp_path, capsys):
    base = ["waterfall", "--family", "wimax", "--snr=12", "--batch", "4",
            "--target-errors", "1", "--max-frames", "4", "--max-iters", "5",
            "--device", "cpu"]
    if match is None:
        assert cli.main([*base, *argv]) == 0
        assert capsys.readouterr().out.startswith("snr=+12.00")
    else:
        with pytest.raises(SystemExit, match=match):
            cli.main([*base, *argv])
