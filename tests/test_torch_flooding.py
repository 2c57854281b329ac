"""The flooding slice against the JAX package on the CPU.

* The port's flooding decode (``ops/bp.py::decode_flooding``, the plain
  version of the short-code kernel's flooding modes) is bit-exact with the
  jnp ``decode_flooding`` on bits, convergence, per-frame and batch
  iteration counts: min-sum with alpha, per-layer alpha and beta, and SCMS.
* Soft output, layered and flooding: the latched posteriors of every frame
  are bit-exact with the jnp path's.
* Sum-product agrees to a stated tolerance: the reference computes phi with
  XLA's CPU ``exp``/``log1p`` and sums it in XLA's order, the port with
  torch's functions in a left fold.
* The native C++ flooding golden pins the port's flooding directly.
* The ``Coder`` serves ``MS``, ``SP``, ``MSCL`` and ``SCMS`` as the
  reference's does, and the CLI ``test`` takes them.
* ``cuda_bp.supported`` admits kernel B's route (small-z 5G NR, layered
  min-sum) and nothing else past 120 circulants.
The CUDA kernel itself runs only on a card (chip_smoke.py)."""
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import native as ref_native
from myldpccppapi_tpu.codes import nr as ref_nr
from myldpccppapi_tpu.ops import bp as ref_bp

from myldpccppapi_torch import Coder, DecoderConfig, interop, nr_code, wimax
from myldpccppapi_torch.campaign import CampaignConfig
from myldpccppapi_torch.cli import main
from myldpccppapi_torch.codes import encode_numpy, ru_precompute
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_long

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")
CODES = {"576r12": (576, "1/2"), "576r34B": (576, "3/4B"), "2304r12": (2304, "1/2")}
#: min-sum weights; "per-layer" gets one alpha per base row of the code
WEIGHTS = {"alpha1.0": dict(normalization=1.0), "alpha0.75": dict(normalization=0.75),
           "per-layer": None, "beta0.25": dict(offset=0.25)}
#: (SNR, noise seed): at 5 dB most frames of the batch converge within 10
#: iterations; at 2 dB some frames run out of them
POINTS = {"5dB": (5.0, 11), "2dB": (2.0, 12)}
BATCH = 16
_REF_FNS = {}


def _llr(code, snr_db, seed, batch=BATCH) -> np.ndarray:
    """Codewords of random info bits through BPSK/AWGN, noise from numpy."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _reference(n, rate, kw, llr):
    """The JAX jnp decode of wimax(n, rate), one compile per (code,
    configuration)."""
    key = (n, rate, tuple(sorted(kw.items())))
    if key not in _REF_FNS:
        cfg = ref.DecoderConfig(implementation="jnp", **kw)
        _REF_FNS[key] = jax.jit(partial(ref_bp.decode_qc, ref.wimax(n, rate), cfg))
    return _REF_FNS[key](jnp.asarray(llr))


def _assert_equal(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def _weights(name, code):
    if WEIGHTS[name] is not None:
        return WEIGHTS[name]
    return dict(normalization=tuple(
        float(x) for x in np.round(np.linspace(0.7, 0.85, code.m_b), 3)))


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("code_name", list(CODES))
def test_decode_flooding_matches_jnp(code_name, weights, early_exit):
    """One configuration with 10 iterations, decoded at a converging point
    and at 2 dB, where frames run out of iterations and any difference in
    the posterior's f32 accumulation order would show."""
    code = wimax(*CODES[code_name])
    kw = dict(_weights(weights, code), schedule="flooding", max_iters=10,
              early_exit=early_exit)
    cfg = DecoderConfig(**kw)
    # each reference configuration costs a ~3 s compile: early exit off is
    # compiled once, at 576 r1/2 alpha 0.75; elsewhere its result is assumed
    # to be the early-exit one with the loop run to max_iters (frames latch,
    # so only total_iters changes), which the compiled case asserts
    derive = not early_exit and (code_name, weights) != ("576r12", "alpha0.75")
    ref_kw = dict(kw, early_exit=True) if derive else kw
    for point, (snr, seed) in POINTS.items():
        llr = _llr(code, snr, seed)
        got = bp.decode_flooding(code, cfg, torch.from_numpy(llr))
        want = _reference(*CODES[code_name], ref_kw, llr)
        if derive:
            want = want._replace(total_iters=np.int32(10))
        elif not early_exit:
            latched = _reference(*CODES[code_name], dict(kw, early_exit=True), llr)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    np.asarray(getattr(latched._replace(total_iters=np.int32(10)), f)),
                    np.asarray(getattr(want, f)), err_msg=f"derived {f}")
        _assert_equal(got, want)
        n_conv = int(got.converged.sum())
        if point == "5dB":
            assert n_conv > BATCH // 2
        else:
            assert n_conv < BATCH and int(got.total_iters) == 10


def test_scms_matches_jnp_and_erases():
    """SCMS at 1.5 dB, bit-exact; its trajectory differs from plain flooding
    on some frame, so erasures fire."""
    code = wimax(576, "1/2")
    llr = _llr(code, 1.5, seed=3, batch=32)
    kw = dict(schedule="flooding", self_correction=True, max_iters=20)
    got = bp.decode_qc(code, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_equal(got, _reference(576, "1/2", kw, llr))
    plain = bp.decode_qc(code, DecoderConfig(schedule="flooding", max_iters=20),
                         torch.from_numpy(llr))
    assert not torch.equal(got.iterations, plain.iterations)
    assert 0 < int(got.converged.sum()) < 32


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_soft_output_matches_jnp(schedule):
    """Latched posteriors of every frame at a mixed-convergence point (1.6 dB,
    8 iterations, as the reference's tests/test_pallas.py soft-output pin),
    consistent with the hard decisions."""
    code = wimax(576, "1/2")
    llr = _llr(code, 1.6, seed=7)
    kw = dict(schedule=schedule, normalization=0.75, max_iters=8, soft_output=True)
    got = bp.decode_qc(code, DecoderConfig(**kw), torch.from_numpy(llr))
    want = _reference(576, "1/2", kw, llr)
    _assert_equal(got, want, FIELDS + ("posteriors",))
    conv = got.converged.numpy()
    assert 0 < conv.sum() < BATCH  # the latch, not just the final state
    assert ((got.posteriors <= 0).to(torch.uint8) == got.bits).all()
    # no sweep: the channel itself
    zero = bp.decode_qc(code, DecoderConfig(**dict(kw, max_iters=0)),
                        torch.from_numpy(llr))
    assert torch.equal(zero.posteriors, torch.from_numpy(llr))
    assert not zero.bits.any()


def test_sumproduct_check_update_matches_jnp():
    """The phi-domain check update on random messages, within rtol 1e-5 and
    atol 1e-6 of the jnp one (XLA's CPU exp/log1p are not torch's)."""
    rng = np.random.default_rng(5)
    qs = (rng.standard_normal((7, 24, 16)) * 6).astype(np.float32)
    qs[2, 3] = 0.0
    got = bp._check_update_sumproduct(torch.from_numpy(qs)).numpy()
    want = np.asarray(ref_bp._check_update_sumproduct(jnp.asarray(qs), 1.0, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_decode_matches_jnp(schedule):
    """Sum-product where every frame converges: the same bits and converged
    flags, per-frame iterations within 1.  The tolerance is for the
    transcendentals: XLA's CPU exp/log1p and its sum order are not
    torch's, so a message may differ in its last bits."""
    code = wimax(576, "1/2")
    llr = _llr(code, 4.0, seed=9)
    kw = dict(schedule=schedule, algorithm="sum-product", max_iters=20)
    got = bp.decode_qc(code, DecoderConfig(**kw), torch.from_numpy(llr))
    want = _reference(576, "1/2", kw, llr)
    assert got.converged.all()
    _assert_equal(got, want, ("bits", "converged"))
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1


@pytest.mark.skipif(not ref_native.available(), reason="native lib not built")
@pytest.mark.parametrize("scms,norm", [(False, 1.0), (False, 0.75), (True, 1.0)])
def test_flooding_matches_native_golden(scms, norm):
    """The reference's C++ flooding golden (the jnp accumulation order)
    against the port's flooding, SCMS included, at a mixed point."""
    code = wimax(576, "1/2")
    llr = _llr(code, 2.5, seed=2, batch=32)
    nb, nc, ni = ref_native.decode_golden_flooding_native(
        ref.wimax(576, "1/2"), llr, max_iters=10, normalization=norm,
        self_correction=scms)
    got = bp.decode_flooding(code, DecoderConfig(
        schedule="flooding", max_iters=10, normalization=norm,
        self_correction=scms), torch.from_numpy(llr))
    assert 0 < nc.sum() < 32
    np.testing.assert_array_equal(got.converged.numpy(), nc)
    np.testing.assert_array_equal(got.iterations.numpy(), ni)
    np.testing.assert_array_equal(got.bits.numpy(), nb)


@pytest.fixture(scope="module")
def soft_stream():
    """A 5 dB soft stream of 19 codewords (the last zero-padded), noise from
    numpy."""
    coder = Coder(432, 576, "3/4B", device="cpu")
    coder.for_encoder()
    src = bytes((ord("a") + i % 26) for i in range(1000))
    bits = np.unpackbits(coder.encode(src), bitorder="little")
    rng = np.random.default_rng(17)
    sigma = np.float32(10 ** (-5.0 / 20))
    post = (1 - 2 * bits.astype(np.float32)
            + sigma * rng.standard_normal(bits.shape).astype(np.float32))
    return src, post.astype(np.float32)


@pytest.mark.parametrize("de_type", ["MS", "SP", "MSCL", "SCMS"])
def test_coder_decode_types_match_reference(soft_stream, de_type):
    """The new decode types on one soft stream, against the reference
    Coder (SP at its default channel scale 8.0)."""
    src, post = soft_stream
    # the whole stream in one batch: one reference compile per type
    mine = Coder(432, 576, "3/4B", device="cpu")
    theirs = ref.Coder(432, 576, "3/4B")
    out, stats = mine.decode(post, len(src), de_type, return_stats=True)
    want, want_stats = theirs.decode(post, len(src), de_type, return_stats=True)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(stats["converged"], want_stats["converged"])
    d_iters = np.abs(stats["iterations"] - want_stats["iterations"]).max()
    assert d_iters <= (1 if de_type == "SP" else 0)  # SP: see the SP tests
    assert bytes(out) == src
    cfg = mine._decoders[de_type].config
    assert cfg.max_iters == (120 if de_type == "MSCL" else 40)
    if de_type == "SP":
        # the default is the reference's 8.0; the unscaled stream decodes
        # otherwise
        for scale, same in ((8.0, True), (1.0, False)):
            other = mine.decode(post, len(src), de_type, llr_scale=scale,
                                return_stats=True)[1]["iterations"]
            assert np.array_equal(other, stats["iterations"]) is same


def test_mscl_never_needs_the_layered_substitution():
    """The reference substitutes the layered schedule for MSCL where its
    fused flooding kernel cannot hold a code; every 802.16e code fits the
    short-code kernel's flooding state (channel, posterior and messages of
    one codeword within a thread block's 227 KB), so the port's 802.16e
    Coder always decodes MSCL by flooding."""
    smem = 232_448
    cfg = DecoderConfig(schedule="flooding", max_iters=120)
    for n in range(576, 2304 + 1, 96):
        for rate in ("1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6"):
            code = wimax(n, rate)
            assert cuda_bp.supported(code, cfg), code.name
            # channel, posterior and messages in f32, with room for tables
            assert 4 * (2 * code.n + code.num_edges) <= smem // 2, code.name


@pytest.mark.parametrize("algo", ["MS", "SP", "MSCL", "SCMS"])
def test_cli_test_new_decode_types(algo, capsys):
    rc = main(["test", "432", "8", "7.0", algo, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ErrNum=0" in out and "ThroughPut=" in out


def test_cli_waterfall_flooding_flags(tmp_path, capsys):
    """``waterfall --algorithm/--schedule/--self-correction`` reach the
    DecoderConfig (its repr is in the checkpoint's fingerprint)."""
    ck = tmp_path / "ck.json"
    argv = ["waterfall", "--family", "wimax", "--n", "576", "--rate", "1/2",
            "--snr", "3", "--batch", "16", "--max-frames", "16",
            "--max-iters", "5", "--schedule", "flooding", "--self-correction",
            "--checkpoint", str(ck), "--device", "cpu"]
    assert main(argv) == 0
    assert "frames=16" in capsys.readouterr().out
    cfg = DecoderConfig(schedule="flooding", self_correction=True, max_iters=5)
    want = CampaignConfig(snr_db=[3.0], batch_per_step=16).fingerprint(
        "wimax_n576_r12", repr(cfg) + "/device=cpu")
    assert json.loads(ck.read_text())["fingerprint"] == want


@pytest.mark.parametrize("z,bg", [(16, 1), (32, 1), (56, 1), (8, 2)])
def test_route_b_supported_on_small_z_nr(z, bg):
    """Kernel B's route: layered min-sum f32 with scalar weights on NR codes
    of more than 120 circulants that kernel C leaves (z < 64); nothing else
    past 120 circulants."""
    code = nr_code(z, bg)
    assert code.num_blocks > 120
    for kw in (dict(), dict(normalization=0.8), dict(offset=0.25)):
        assert cuda_bp.supported(code, DecoderConfig(**kw)), kw
    for kw in (dict(soft_output=True), dict(schedule="flooding"),
               dict(algorithm="sum-product"),
               dict(normalization=tuple([0.8] * code.m_b))):
        assert not cuda_bp.supported(code, DecoderConfig(**kw)), kw
    assert not cuda_long.supported(code, DecoderConfig())


def test_route_b_leaves_z64_to_the_long_code_kernel():
    code = nr_code(64, 1)
    assert not cuda_bp.supported(code, DecoderConfig())
    assert cuda_long.supported(code, DecoderConfig())
    # kernel A's modes stay within 120 circulants
    wide = interop.code_from_reference(ref_nr.nr_code(16, 1))
    assert not cuda_bp.supported(wide, DecoderConfig(schedule="flooding"))
