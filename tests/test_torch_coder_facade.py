"""The port's byte-stream facade beyond 802.16e: ``make_codec`` for every
family, ``Coder(code=..., encoders=..., crc=...)`` and ``_resolve_mscl``,
held against the JAX package's (``myldpccppapi_tpu/coder.py``) on the same
source bytes and the same soft streams (noise from numpy: the two packages'
``test`` draw from different generators)."""
import dataclasses

import numpy as np
import pytest
import torch

import myldpccppapi_tpu.coder as ref_coder
from myldpccppapi_tpu.codes.base_matrices import WIFI_SEEDS as REF_WIFI_SEEDS
from myldpccppapi_tpu.codes.wifi import wifi as ref_wifi

from myldpccppapi_torch import make_codec
from myldpccppapi_torch.codes import Encoder, encode_numpy, wifi
from myldpccppapi_torch.codes.base_matrices import WIFI_SEEDS
from myldpccppapi_torch.coder import DECODE_TYPES
from myldpccppapi_torch.ops.packing import unpack_bits_np

torch.set_num_threads(1)

FAMILIES = {
    "wimax": dict(n=576, rate="3/4B"),
    "wifi": dict(n=648, rate="1/2"),  # k = 324: not byte-aligned
    "regular": dict(n=648),           # rank-deficient information set
    "nr": dict(z=16, bg=2),
    "rs_ldpc": dict(n=1024),
}
SRC = bytes((ord("a") + i % 26) for i in range(300))


def _codecs(family):
    kw = FAMILIES[family]
    mine = make_codec(family, device="cpu", **kw)
    theirs = ref_coder.make_codec(family, **kw)
    for c in (mine, theirs):
        c.for_encoder()
        c.for_decoder(16)
    return mine, theirs


def _soft(prior, snr_db, seed):
    bits = unpack_bits_np(np.asarray(prior, np.uint8))
    sigma = np.float32(10 ** (-snr_db / 20))
    rng = np.random.default_rng(seed)
    return (1 - 2 * bits.astype(np.float32)
            + sigma * rng.standard_normal(bits.shape).astype(np.float32))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_codec_encodes_as_the_reference(family):
    mine, theirs = _codecs(family)
    assert mine.code.name == theirs.code.name
    assert mine.get_code_size(len(SRC)) == theirs.get_code_size(len(SRC))
    prior = mine.encode(SRC)
    np.testing.assert_array_equal(prior, theirs.encode(SRC))
    cw = unpack_bits_np(prior).reshape(-1, mine.code.n)
    assert not mine.code.syndrome(cw).any()


@pytest.mark.parametrize("de_type", ["TDMP", "CPU"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_same_soft_stream_decodes_alike(family, de_type):
    mine, theirs = _codecs(family)
    post = _soft(mine.encode(SRC), 7.0, seed=7)
    got, stats = mine.decode(post, len(SRC), de_type, return_stats=True)
    want, ref_stats = theirs.decode(post, len(SRC), de_type, return_stats=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stats["converged"], ref_stats["converged"])
    np.testing.assert_array_equal(stats["iterations"], ref_stats["iterations"])
    assert bytes(got) == SRC


def test_crc_round_trip():
    """CRC-aided stream (tests/test_coder_facade.py:97-119): the payload
    shrinks by the CRC field, encode attaches it, decode needs syndrome
    AND CRC and reports the split, as the reference does."""
    mine = make_codec("wimax", 576, "1/2", crc="16", device="cpu")
    theirs = ref_coder.make_codec("wimax", 576, "1/2", crc="16")
    assert mine._kb == theirs._kb == (288 - 16) // 8
    for c in (mine, theirs):
        c.for_encoder()
        c.for_decoder(16)
    src = bytes(range(100))
    prior = mine.encode(src)
    np.testing.assert_array_equal(prior, theirs.encode(src))
    assert len(prior) == mine.get_prior_code_length(len(src))
    post = _soft(prior, 5.0, seed=1)
    for de_type in ("TDMP", "CPU"):
        got, stats = mine.decode(post, len(src), de_type, return_stats=True)
        _, ref_stats = theirs.decode(post, len(src), de_type, return_stats=True)
        assert got.tobytes() == src
        assert stats["accepted"].all() and stats["crc_rejected"] == 0
        np.testing.assert_array_equal(stats["accepted"], ref_stats["accepted"])


@pytest.mark.parametrize("de_type", ["TDMP", "CPU"])
def test_crc_rejects_a_forged_codeword(de_type):
    """A valid LDPC codeword whose info block has a broken CRC field is
    not accepted (tests/test_coder_facade.py:121-150)."""
    mine = make_codec("wimax", 576, "1/2", crc="16", device="cpu")
    theirs = ref_coder.make_codec("wimax", 576, "1/2", crc="16")
    mine.for_encoder()
    mine.for_decoder(4)
    theirs.for_decoder(4)
    src = bytes(range(34))  # exactly one codeword's payload
    bits = unpack_bits_np(np.asarray(mine.encode(src), np.uint8))[:576].copy()
    info = bits[:288].copy()
    info[3] ^= 1  # break message vs CRC consistency
    cw = encode_numpy(Encoder(mine.code, device="cpu").mats, info[None, :])
    post = ((1.0 - 2.0 * cw.astype(np.float32)) * 5.0).reshape(-1)
    _, stats = mine.decode(post, len(src), de_type=de_type, return_stats=True)
    _, ref_stats = theirs.decode(post, len(src), de_type=de_type, return_stats=True)
    assert not stats["accepted"].any() and stats["crc_rejected"] == 1
    assert ref_stats["crc_rejected"] == 1


def test_make_codec_errors():
    with pytest.raises(ValueError, match="unknown family"):
        make_codec("polar", device="cpu")
    with pytest.raises(ValueError, match="fixed"):
        make_codec("rs_ldpc", 2048, "1/3", device="cpu")
    with pytest.raises(ValueError, match="32"):
        make_codec("rs_ldpc", 2000, device="cpu")
    with pytest.raises(ValueError, match="unknown crc"):
        make_codec("wimax", 576, "1/2", crc="7", device="cpu")


def test_resolve_mscl_on_the_cpu_keeps_the_config():
    for family in ("wimax", "rs_ldpc"):
        coder = make_codec(family, device="cpu", **FAMILIES[family])
        cfg = dataclasses.replace(DECODE_TYPES["MSCL"], msg_dtype="float32")
        assert coder._resolve_mscl(cfg) == cfg
        coder.add_decode_type("MSCL")
        dec = coder._decoders["MSCL"]
        assert dec.implementation == "torch" and dec.config.schedule == "flooding"


def test_custom_encoders_take_the_torch_function_for_long_streams():
    """``encoders=(numpy_fn, torch_fn)``: a stream of 256 codewords or more
    goes through the torch encoder; both give the same bytes."""
    coder = make_codec("nr", z=16, bg=2, device="cpu")
    coder.for_encoder()
    src = bytes(range(256)) * (coder._kb + 1)
    assert coder.get_code_size(len(src)) >= 256
    calls = []
    enc_np, enc_t = coder._encode_np, coder._encode_torch
    coder._encode_torch = lambda u: calls.append(1) or enc_t(u)
    prior = coder.encode(src)
    assert calls
    coder._encode_torch = None
    np.testing.assert_array_equal(prior, coder.encode(src))
    assert enc_np is coder._encode_np


@pytest.mark.parametrize("key", sorted(REF_WIFI_SEEDS))
def test_wifi_tables_match_reference(key):
    n, rate = int(key[0]), key[1]
    np.testing.assert_array_equal(WIFI_SEEDS[key], REF_WIFI_SEEDS[key])
    mine, theirs = wifi(n, rate), ref_wifi(n, rate)
    assert (mine.name, mine.z, mine.k) == (theirs.name, theirs.z, theirs.k)
    np.testing.assert_array_equal(mine.base, np.asarray(theirs.base))
    assert set(WIFI_SEEDS) == set(REF_WIFI_SEEDS)
