"""Noisy-GDBF bit flipping in the port against the JAX package on the CPU:
bit-exact without the perturbation, statistically with it (the reference's
threefry noise and torch's generator differ), the latch and budget
semantics, the ``Decoder`` facade and the ``Coder`` decode type ``BF``.

Tolerances: at ``noise_scale=0`` every field is equal.  The scaled
channel term (y over its per-frame mean |y|) is a reduction whose order
XLA and torch choose otherwise: it is held to rtol 1e-6 (measured: last-bit
differences), and no decision here turns on that bit.  With noise, the
converged fractions and FERs of the two packages at one point are held to
4 binomial sigmas of their difference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import rs_ldpc as ref_rs_ldpc
from myldpccppapi_tpu.ops import bitflip as ref_bitflip

from myldpccppapi_torch import Coder, Decoder, interop, make_codec
from myldpccppapi_torch.codes import dvbs2_oracle, encode_numpy, rs_ldpc, ru_precompute, wimax
from myldpccppapi_torch.ops.bitflip import GDBFConfig, decode_gdbf

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")
CODES = {
    "wimax576_r34B": (wimax(576, "3/4B"), ref.wimax(576, "3/4B"), 6.5),
    "rs_ldpc_4_4_8": (rs_ldpc(4, 4, 8), ref_rs_ldpc(4, 4, 8), 5.0),
}


def _case(code, batch, snr_db, seed):
    rng = np.random.default_rng(seed)
    mats = getattr(code, "encoder_matrices", None) or ru_precompute(code)
    u = rng.integers(0, 2, size=(batch, mats.w.shape[1]), dtype=np.uint8)
    c = encode_numpy(mats, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return u, c, (y * np.float32(2 / sigma**2)).astype(np.float32)


def _equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("kw", [dict(), dict(theta=-0.3, max_iters=30),
                                dict(channel_weight=0.5, max_iters=40)],
                         ids=["default", "theta", "weight"])
def test_noiseless_bitexact(name, kw):
    code, ref_code, snr = CODES[name]
    _, _, llr = _case(code, 256, snr, seed=1)
    cfg = dict(noise_scale=0.0, **kw)
    got = decode_gdbf(code, GDBFConfig(**cfg), torch.from_numpy(llr))
    want = ref_bitflip.decode_gdbf(ref_code, ref_bitflip.GDBFConfig(**cfg), jnp.asarray(llr))
    conv = np.asarray(want.converged).mean()
    assert 0.0 < conv < 1.0, conv
    _equal(got, want)


def test_scaled_channel_term_within_rtol():
    code, _, snr = CODES["wimax576_r34B"]
    _, _, llr = _case(code, 256, snr, seed=1)
    y = torch.from_numpy(llr).t().reshape(code.n_b, code.z, -1)
    got = y / torch.clamp(y.abs().mean(dim=(0, 1), keepdim=True), min=1e-30)
    yr = jnp.asarray(llr).T.reshape(code.n_b, code.z, -1)
    want = jax.jit(lambda x: x / jnp.maximum(
        jnp.mean(jnp.abs(x), axis=(0, 1), keepdims=True), 1e-30))(yr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_noisy_agrees_statistically():
    """Convergence and FER at wimax 576 r3/4B, 7 dB, 1024 frames: the
    port's generator against the reference's threefry key."""
    code, ref_code, _ = CODES["wimax576_r34B"]
    u, _, llr = _case(code, 1024, 7.0, seed=2)
    cfg = dict(max_iters=60)
    got = decode_gdbf(code, GDBFConfig(**cfg), torch.from_numpy(llr),
                      torch.Generator().manual_seed(3))
    want = ref_bitflip.decode_gdbf(ref_code, ref_bitflip.GDBFConfig(**cfg),
                                   jnp.asarray(llr), key=jax.random.PRNGKey(3))
    bits_w = np.asarray(want.bits)
    stats = []
    for conv, bits in ((got.converged.numpy(), got.bits.numpy()),
                       (np.asarray(want.converged), bits_w)):
        fer = (bits[:, : code.k] != u).any(axis=1).mean()
        stats.append((conv.mean(), fer))
    for i in range(2):
        p = 0.5 * (stats[0][i] + stats[1][i])
        sd = np.sqrt(2 * p * (1 - p) / 1024)
        assert abs(stats[0][i] - stats[1][i]) <= 4 * sd + 1e-12, stats
    assert 0.05 < stats[0][0] < 0.995, stats  # a point inside the waterfall
    # converged frames hold a zero syndrome
    bits = got.bits.numpy()[got.converged.numpy()]
    assert not code.syndrome(bits).any()


def test_noise_depends_on_the_generator_only():
    code, _, _ = CODES["wimax576_r34B"]
    _, _, llr = _case(code, 64, 6.0, seed=4)
    x = torch.from_numpy(llr)
    a = decode_gdbf(code, GDBFConfig(max_iters=30), x)
    b = decode_gdbf(code, GDBFConfig(max_iters=30), x, torch.Generator().manual_seed(0))
    c = decode_gdbf(code, GDBFConfig(max_iters=30), x, torch.Generator().manual_seed(1))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.iterations, c.iterations)


def test_early_exit_false_runs_full_budget():
    code, _, _ = CODES["wimax576_r34B"]
    _, c, _ = _case(code, 4, 8.0, seed=5)
    llr = torch.from_numpy((1.0 - 2.0 * c) * 4.0).float()  # noiseless
    res = decode_gdbf(code, GDBFConfig(early_exit=False, max_iters=12), llr)
    assert int(res.total_iters) == 12
    assert res.converged.all()
    assert (res.iterations == 1).all()  # latched at convergence
    on = decode_gdbf(code, GDBFConfig(max_iters=12), llr)
    assert int(on.total_iters) == 1


def test_decoder_facade_gdbf_matches_reference():
    code, ref_code, _ = CODES["wimax576_r34B"]
    u, _, llr = _case(code, 128, 7.0, seed=6)
    dec = Decoder(code, GDBFConfig(max_iters=60, noise_scale=0.0), device="cpu")
    assert dec.implementation == "gdbf"
    got = dec(llr)
    theirs = ref.Decoder(ref_code, ref_bitflip.GDBFConfig(max_iters=60, noise_scale=0.0))
    assert theirs.implementation == "gdbf"
    want = theirs(jnp.asarray(llr))
    _equal(got, want)
    np.testing.assert_array_equal(dec.info_bits(got).numpy(),
                                  np.asarray(theirs.info_bits(want)))
    # with the default noise: the fixed seed, the same result twice
    noisy = Decoder(code, GDBFConfig(), device="cpu")
    first, second = noisy(llr), noisy(llr)
    for f in FIELDS:
        assert torch.equal(getattr(first, f), getattr(second, f)), f
    assert interop.config_from_reference(ref_bitflip.GDBFConfig(theta=-0.2)) == \
        GDBFConfig(theta=-0.2)


def test_decoder_facade_gdbf_rejects_edgelist_codes():
    with pytest.raises(ValueError, match="block-structured"):
        Decoder(dvbs2_oracle(16200, "1/2"), GDBFConfig(), device="cpu")
    with pytest.raises(TypeError, match="code_from_reference"):
        Decoder(ref.wimax(576, "1/2"), GDBFConfig(), device="cpu")


def test_coder_bf_roundtrip_matches_reference():
    coder = Coder(288, 576, "1/2", device="cpu")
    theirs = ref.Coder(288, 576, "1/2")
    for c in (coder, theirs):
        c.for_encoder()
        c.for_decoder(16)
    src = np.arange(16 * coder._kb, dtype=np.uint8)
    prior = coder.encode(src)
    np.testing.assert_array_equal(prior, np.asarray(theirs.encode(src)))
    post = coder.test(prior, sigma=0.21, seed=0)  # ~7.5 dB
    out, stats = coder.decode(post, len(src), de_type="BF", return_stats=True)
    np.testing.assert_array_equal(out, src)
    assert coder._decoders["BF"].config.max_iters == 100  # its own budget
    assert coder._decoders["BF"].implementation == "gdbf"
    # noiseless: the reference's decode of the same stream, byte for byte
    clean = (1.0 - 2.0 * np.unpackbits(prior, bitorder="little")).astype(np.float32)
    np.testing.assert_array_equal(coder.decode(clean, len(src), de_type="BF"),
                                  np.asarray(theirs.decode(clean, len(src), de_type="BF")))
    assert stats["converged"].all()


def test_coder_bf_rejects_crc():
    coder = make_codec("wimax", 576, "1/2", crc="16", device="cpu")
    coder.for_decoder(8)
    with pytest.raises(ValueError, match="BP-path"):
        coder.add_decode_type("BF")


def test_cli_test_bf_roundtrip(capsys):
    """CLI ``test`` with the reference's decode type ``BF`` on the CPU."""
    from myldpccppapi_torch.cli import main

    assert main(["test", "4320", "64", "10.0", "BF", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ErrNum=0" in out and "ThroughPut=" in out
