"""The port's Decoder facade (dispatch, triage, refusals) against the JAX
package's Decoder on the CPU."""
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref

from myldpccppapi_torch import Decoder, DecoderConfig, wimax
from myldpccppapi_torch.codes import encode_numpy, ru_precompute
from myldpccppapi_torch.ops.bp import decode_layered

torch.set_num_threads(1)

CODE = wimax(576, "3/4B")
REF_CODE = ref.wimax(576, "3/4B")
#: bench.py's configuration: layered NMS alpha 0.75, 40 iterations, a
#: 5-iteration triage fast pass with the default 1/8 straggler buffer
BENCH = dict(algorithm="min-sum", schedule="layered", normalization=0.75,
             max_iters=40, triage_iters=5, triage_cap_frac=0.125)
FIELDS = ("bits", "converged", "iterations", "total_iters")


def _llr(snr_db, batch, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, CODE.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(CODE), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return u, (y * np.float32(2 / sigma**2)).astype(np.float32)


@pytest.fixture(scope="module")
def decoders():
    return (Decoder(CODE, DecoderConfig(**BENCH), device="cpu"),
            ref.Decoder(REF_CODE, ref.DecoderConfig(**BENCH)))


@pytest.mark.parametrize("snr_db,branch", [(5.0, "retry"), (2.0, "fallback")])
def test_triage_decoder_matches_reference(decoders, snr_db, branch):
    mine, theirs = decoders
    assert mine.implementation == "torch"
    batch = 96  # straggler buffer: max(8, 96 // 8) = 12 frames
    u, llr = _llr(snr_db, batch, seed=21)
    fast = decode_layered(CODE, DecoderConfig(normalization=0.75, max_iters=5),
                          torch.from_numpy(llr))
    n_bad = int((~fast.converged).sum())
    assert (0 < n_bad <= 12) if branch == "retry" else n_bad > 12
    got = mine(llr)
    want = theirs(llr)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    single = decode_layered(CODE, DecoderConfig(normalization=0.75),
                            torch.from_numpy(llr))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    np.testing.assert_array_equal(mine.info_bits(got).numpy(),
                                  np.asarray(theirs.info_bits(want)))
    if branch == "retry":
        assert (mine.info_bits(got).numpy() != u).sum() <= (
            int((~got.converged).sum()) * CODE.k)


def test_small_batch_skips_triage():
    """A batch no larger than the straggler buffer decodes in one pass."""
    _, llr = _llr(4.0, 8, seed=5)
    got = Decoder(CODE, DecoderConfig(**BENCH), device="cpu")(torch.from_numpy(llr))
    want = decode_layered(CODE, DecoderConfig(normalization=0.75),
                          torch.from_numpy(llr))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


#: configurations an earlier slice refused and a later one serves
PORTED = (dict(schedule="flooding"), dict(algorithm="sum-product"),
          dict(schedule="flooding", self_correction=True),
          dict(soft_output=True), dict(msg_dtype="bfloat16"), dict(crc="16"),
          dict(outer=("bch", 16, 12)), dict(implementation="edgelist"))


@pytest.mark.parametrize("kwargs", [
    dict(schedule="flooding"),
    dict(algorithm="sum-product"),
    dict(schedule="flooding", self_correction=True),
    dict(msg_dtype="bfloat16"),
    dict(crc="16"),
    dict(outer=("bch", 16, 12)),
    dict(soft_output=True),
    dict(implementation="edgelist"),
    dict(normalization=((0.7,), (0.8,))),
])
def test_unported_configs_raise_not_implemented(kwargs):
    """What the port does not serve yet raises naming its ROADMAP item;
    the flooding, sum-product, SCMS, soft-output, bf16, CRC and outer-BCH
    configurations, ported since, construct and decode on the CPU's torch
    path as the reference's jnp path does (bf16 too at this point, alpha 1:
    both round after every operation; the CRC and BCH latch, whose frames
    here never pass the check, run to the cap alike); the edge-list path,
    ported since, as the reference's edge-list path does."""
    if kwargs not in PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DecoderConfig(**kwargs)
        return
    cfg = DecoderConfig(max_iters=10, **kwargs)
    dec = Decoder(CODE, cfg, device="cpu")
    assert dec.implementation == kwargs.get("implementation", "torch")
    _, llr = _llr(4.0, 8, seed=5)
    got = dec(torch.from_numpy(llr))
    want = ref.Decoder(REF_CODE, ref.DecoderConfig(max_iters=10, **kwargs))(llr)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (got.posteriors is None) == (not cfg.soft_output)
    assert (got.accepted is None) == (cfg.crc is None and cfg.outer is None)
    if got.accepted is not None:
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))


@pytest.mark.parametrize("kwargs", [
    dict(syndrome_mode="lazy"),
    dict(implementation="cuda_long", syndrome_mode="lazy"),
])
def test_lazy_syndrome_configs_are_accepted(kwargs):
    """The long-code kernel serves the lazy syndrome; the torch path, like
    the reference's jnp path, checks exactly whatever the mode says."""
    cfg = DecoderConfig(**kwargs)
    assert cfg.syndrome_mode == "lazy"
    if cfg.implementation == "auto":
        _, llr = _llr(4.0, 8, seed=5)
        got = Decoder(CODE, cfg, device="cpu")(torch.from_numpy(llr))
        want = decode_layered(CODE, DecoderConfig(), torch.from_numpy(llr))
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("kwargs", [
    dict(algorithm="belief"),
    dict(schedule="random"),
    dict(implementation="jnp"),
    dict(implementation="pallas"),
    dict(msg_dtype="float16"),
    dict(algorithm="sum-product", normalization=0.75),
    dict(self_correction=True),
    dict(crc_span=10),
    dict(outer=("rs", 1, 2)),
])
def test_invalid_configs_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        DecoderConfig(**kwargs)


def test_decoder_refusals():
    # the reference's construction refusals
    with pytest.raises(ValueError, match="triage"):
        Decoder(CODE, device="cpu", soft_output=True, triage_iters=5)
    with pytest.raises(ValueError, match="SCMS"):
        Decoder(CODE, device="cpu", schedule="flooding", self_correction=True,
                implementation="cuda_long")
    with pytest.raises(ValueError, match="CUDA device"):
        Decoder(CODE, DecoderConfig(implementation="cuda"), device="cpu")
    with pytest.raises(ValueError, match="per-layer"):
        Decoder(CODE, device="cpu", normalization=(0.75, 0.8))(
            np.zeros((1, CODE.n), np.float32))
    with pytest.raises(ValueError, match="shape"):
        Decoder(CODE, device="cpu")(np.zeros((2, CODE.n - 1), np.float32))
    with pytest.raises(TypeError, match="code_from_reference"):
        Decoder(REF_CODE, device="cpu")
    dense = type(CODE)(name="dense", base=np.zeros((12, 24), np.int32), z=24)
    assert Decoder(dense, device="cpu").implementation == "torch"  # auto on the CPU


def test_cuda_decoder_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(CODE, device="cuda")
