"""Code construction, encoding, packing, channel and golden decoder of the
PyTorch port, held against the JAX package on the same NumPy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import encoder as ref_encoder
from myldpccppapi_tpu.ops import channel as ref_channel
from myldpccppapi_tpu.ops import golden as ref_golden
from myldpccppapi_tpu.ops import packing as ref_packing

from myldpccppapi_torch import Decoder, interop
from myldpccppapi_torch.codes import (
    Encoder,
    encode_numpy,
    ru_precompute,
    wimax,
)
from myldpccppapi_torch.ops import channel, golden, packing
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

RATES = ("1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6")
CODES = [(576, r) for r in RATES] + [(2304, "1/2")]


@pytest.mark.parametrize("n,rate", CODES)
def test_code_structure_and_encoder_matrix_match(n, rate):
    mine, theirs = wimax(n, rate), ref.wimax(n, rate)
    assert mine.name == theirs.name
    for a, b in zip(mine.blocks, theirs.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.layer_ptr, theirs.layer_ptr)
    np.testing.assert_array_equal(mine.h_dense(), theirs.h_dense())
    mats, ref_mats = ru_precompute(mine), ref_encoder.ru_precompute(theirs)
    np.testing.assert_array_equal(mats.w, ref_mats.w)
    assert mats.gap == ref_mats.gap


@pytest.mark.parametrize("rate", RATES)
def test_encode_matches_reference(rate):
    code = wimax(576, rate)
    ref_enc = ref.Encoder(ref.wimax(576, rate))
    u = np.random.default_rng(7).integers(0, 2, size=(24, code.k), dtype=np.uint8)
    want = np.asarray(ref_enc(jnp.asarray(u)))
    got = Encoder(code, device="cpu")(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(encode_numpy(ru_precompute(code), u), want)
    assert not code.syndrome(got).any()


def test_packing_matches_reference():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(5, 54), dtype=np.uint8)
    bits = packing.unpack_bits_np(data)
    np.testing.assert_array_equal(bits, ref_packing.unpack_bits_np(data))
    np.testing.assert_array_equal(bits, np.asarray(
        ref_packing.unpack_bits(jnp.asarray(data))))
    np.testing.assert_array_equal(packing.pack_bits_np(bits), data)
    np.testing.assert_array_equal(packing.pack_bits_np(bits),
                                  ref_packing.pack_bits_np(bits))
    with pytest.raises(ValueError):
        packing.pack_bits_np(bits[:, :-1])


def test_interop_round_trips():
    theirs = ref.wimax(576, "3/4B")
    mine = interop.code_from_reference(theirs)
    for a, b in zip(mine.blocks, wimax(576, "3/4B").blocks):
        np.testing.assert_array_equal(a, b)
    assert (mine.name, mine.z, mine.n, mine.k) == (theirs.name, theirs.z,
                                                   theirs.n, theirs.k)
    ref_mats = ref_encoder.ru_precompute(theirs)
    mats = interop.encoder_from_reference(ref_mats)
    np.testing.assert_array_equal(mats.w, ru_precompute(mine).w)
    ref_cfg = ref.DecoderConfig(normalization=0.75, triage_iters=5,
                                implementation="jnp")
    cfg = interop.config_from_reference(ref_cfg)
    assert cfg == DecoderConfig(normalization=0.75, triage_iters=5,
                                implementation="torch")
    assert interop.config_from_reference(
        dataclasses.replace(ref_cfg, implementation="pallas")
    ).implementation == "cuda"
    scms = ref.DecoderConfig(schedule="flooding", self_correction=True,
                             soft_output=True, implementation="pallas")
    assert interop.config_from_reference(scms) == DecoderConfig(
        schedule="flooding", self_correction=True, soft_output=True,
        implementation="cuda")
    assert interop.config_from_reference(
        ref.DecoderConfig(msg_dtype="bfloat16", crc="16")
    ) == DecoderConfig(msg_dtype="bfloat16", crc="16")
    assert interop.config_from_reference(
        ref.DecoderConfig(implementation="edgelist")
    ) == DecoderConfig(implementation="edgelist")
    # a per-iteration schedule carries across, served by the torch path
    assert interop.config_from_reference(
        ref.DecoderConfig(normalization=((0.7,), (0.8,)))
    ) == DecoderConfig(normalization=((0.7,), (0.8,)))


def test_information_set_encoder_via_interop():
    """A rank-deficient code's permuted encoder (reference
    generic_precompute) carried across: the port's Encoder and Decoder
    honour perm and info_cols; the port's own information-set precompute
    builds the same matrices."""
    theirs = ref.regular(96)
    ref_mats = ref_encoder.generic_precompute(theirs.h_dense())
    mine = interop.code_from_reference(theirs)
    mats = interop.encoder_from_reference(ref_mats)
    u = np.random.default_rng(1).integers(0, 2, size=(5, mine.k_info),
                                          dtype=np.uint8)
    want = ref_encoder.encode_numpy(ref_mats, u)
    got = Encoder(mine, mats, device="cpu")(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(encode_numpy(mats, u), want)
    assert not mine.syndrome(got).any()
    dec = Decoder(mine, device="cpu")
    res = dec(4.0 * (1.0 - 2.0 * got.astype(np.float32)))
    np.testing.assert_array_equal(dec.info_bits(res).numpy(), u)
    own = Encoder(mine, device="cpu")
    np.testing.assert_array_equal(own.mats.w, np.asarray(ref_mats.w))
    np.testing.assert_array_equal(own.mats.perm, np.asarray(ref_mats.perm))
    np.testing.assert_array_equal(own(torch.from_numpy(u)).numpy(), want)


@pytest.mark.parametrize("snr_db", [5.0, 2.0, -1.5])
def test_channel_llr_matches_reference(snr_db):
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(16, 576), dtype=np.uint8)
    noise = rng.standard_normal(bits.shape).astype(np.float32)
    sigma = channel.sigma_from_snr_db(snr_db)
    ref_sigma = ref_channel.sigma_from_snr_db(snr_db)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma), rtol=1e-6)
    y = channel.bpsk_modulate(torch.from_numpy(bits)) + sigma * torch.from_numpy(noise)
    ref_y = ref_channel.bpsk_modulate(jnp.asarray(bits)) + ref_sigma * noise
    np.testing.assert_allclose(channel.channel_llr(y, sigma).numpy(),
                               np.asarray(ref_channel.channel_llr(ref_y, ref_sigma)),
                               rtol=1e-6)


def test_channel_noise_moments():
    gen = torch.Generator().manual_seed(5)
    bits = torch.zeros((256, 576), dtype=torch.uint8)
    llr, sigma = channel.transmit(gen, bits, snr_db=3.0, llr_scale=1.0)
    noise = (llr - 1.0).double()
    # 147,456 samples: standard errors 0.0026 sigma (mean) and 0.0018 sigma
    # (std), so both bounds sit near 4-5 standard errors
    assert abs(noise.mean().item()) < 0.01 * sigma.item()
    assert abs(noise.std().item() / sigma.item() - 1.0) < 0.01
    # the same seed gives the same noise; the default scale is 2 / sigma^2
    again, _ = channel.transmit(torch.Generator().manual_seed(5), bits, 3.0)
    np.testing.assert_array_equal(again.numpy(),
                                  channel.channel_llr(llr, sigma).numpy())


def test_golden_matches_reference():
    code, theirs = wimax(576, "1/2"), ref.wimax(576, "1/2")
    u = np.random.default_rng(2).integers(0, 2, size=(6, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    rng = np.random.default_rng(4)
    llr = (1 - 2 * c.astype(np.float32)) + 0.8 * rng.standard_normal(c.shape)
    got = golden.decode_golden(code, llr, max_iters=20)
    want = ref_golden.decode_golden(theirs, llr, max_iters=20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
