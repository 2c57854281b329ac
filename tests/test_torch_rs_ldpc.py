"""RS-LDPC (the 802.3an family) in the port: the construction, the xor
group's alignment in the torch path (kernel A's plain version), the
information-set encoder and the dispatch are held against the JAX package
on the same NumPy inputs.  The torch path is bit-exact with the reference's
jnp path and with its Pallas kernel A (interpret mode) in min-sum; the
sum-product and bf16 decodes agree as the reference's policy asks (equal
hard outputs at a converging point, every frame to the true codeword).
chip_smoke.py (phase 3i) pins the CUDA kernel's xor mode to this path on
the card."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes.rs_ldpc import gf2m_tables as ref_gf2m_tables
from myldpccppapi_tpu.codes.rs_ldpc import rs_ldpc as ref_rs_ldpc
from myldpccppapi_tpu.codes.encoder import encode_numpy as ref_encode_numpy
from myldpccppapi_tpu.ops.bp import decode_qc as ref_decode_qc
from myldpccppapi_tpu.ops.pallas_bp import decode_qc_pallas

from myldpccppapi_torch import Decoder, cli, interop
from myldpccppapi_torch.codes import Encoder, encode_numpy
from myldpccppapi_torch.codes.rs_ldpc import gf2m_tables, rs_ldpc, rs_ldpc_from_n
from myldpccppapi_torch.ops import bp, cuda_bp, cuda_long
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

SMALL = (4, 4, 8)  # GF(16), (4, 8)-regular, n = 128
FIELDS = ("bits", "converged", "iterations", "total_iters")
#: at 5 dB every frame of the small code converges, at 2 dB about half
SNRS = (5.0, 2.0)
BATCH = 16


@pytest.fixture(scope="module")
def default_codes():
    """The 802.3an-class (2048, 1723) code in both packages, built once:
    its rank-325 information-set precompute is the expensive part."""
    mine, theirs = rs_ldpc(), ref_rs_ldpc()
    assert mine.k_info == theirs.k_info == 1723
    return mine, theirs


def _small():
    return rs_ldpc(*SMALL), ref_rs_ldpc(*SMALL)


def _llr(code, snr_db, seed, batch=BATCH):
    """Codewords of random info bits (the code's information-set encoder)
    through BPSK/AWGN, noise from numpy: (info bits, LLRs)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k_info), dtype=np.uint8)
    c = encode_numpy(code.encoder_matrices, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return u, (y * np.float32(2 / sigma**2)).astype(np.float32)


def _assert_equal(got, want, posteriors=False):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if posteriors:
        np.testing.assert_array_equal(got.posteriors.numpy(),
                                      np.asarray(want.posteriors))


# -- construction --------------------------------------------------------------

@pytest.mark.parametrize("params", [SMALL, (5, 6, 32), "default"])
def test_construction_matches_reference(params, default_codes):
    if params == "default":
        mine, theirs = default_codes
    else:
        mine, theirs = rs_ldpc(*params), ref_rs_ldpc(*params)
    assert mine.name == theirs.name and (mine.n, mine.m, mine.z) == (theirs.n, theirs.m, theirs.z)
    np.testing.assert_array_equal(mine.shifts, theirs.shifts)
    for a, b in zip(mine.h_coo(), theirs.h_coo()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.blocks, theirs.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.layer_ptr, theirs.layer_ptr)
    assert mine.k_info == theirs.k_info
    np.testing.assert_array_equal(mine.info_positions, theirs.info_positions)


def test_gf_tables_match_reference():
    for s in (4, 5, 6, 7, 8):
        for a, b in zip(gf2m_tables(s), ref_gf2m_tables(s)):
            np.testing.assert_array_equal(a, b)


def test_rs_ldpc_from_n_and_validation():
    code = rs_ldpc_from_n(1024)
    assert (code.n, code.z, code.num_blocks) == (1024, 32, 192)
    with pytest.raises(ValueError, match="32"):
        rs_ldpc_from_n(2000)
    with pytest.raises(ValueError):
        rs_ldpc(s=4, gamma=16, rho=8)
    with pytest.raises(ValueError):
        rs_ldpc(s=4, gamma=4, rho=8, slopes=np.array([0, 1, 2, 3]))


# -- the xor group in the torch path -------------------------------------------

@pytest.mark.parametrize("c", range(16))
def test_xor_aligner_is_the_permutation(c):
    code = rs_ldpc(*SMALL)
    row_align, col_align = bp._aligners(code)
    assert row_align is col_align  # self-inverse
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((16, 3)).astype(np.float32))
    np.testing.assert_array_equal(row_align(x, c).numpy(), x.numpy()[np.arange(16) ^ c])
    np.testing.assert_array_equal(col_align(row_align(x, c), c).numpy(), x.numpy())


def test_syndrome_gather_reads_the_xor_variables():
    code = rs_ldpc(*SMALL)
    u, llr = _llr(code, 9.0, seed=1, batch=4)
    cw = encode_numpy(code.encoder_matrices, u)
    blocks = torch.from_numpy(cw.T.reshape(code.n_b, code.z, -1).astype(bool))
    assert not bp._syndrome_fail(blocks, code).any()
    cw[:, 5] ^= 1
    blocks = torch.from_numpy(cw.T.reshape(code.n_b, code.z, -1).astype(bool))
    assert bp._syndrome_fail(blocks, code).all()


_REF_FNS = {}


def _reference(theirs, kw, llr):
    key = (theirs.name, tuple(sorted(kw.items())))
    if key not in _REF_FNS:
        cfg = ref.DecoderConfig(implementation="jnp", **kw)
        _REF_FNS[key] = jax.jit(partial(ref_decode_qc, theirs, cfg))
    return _REF_FNS[key](jnp.asarray(llr))


MIN_SUM = {
    "layered": dict(normalization=0.75, max_iters=20),
    "layered-per-layer": dict(normalization=(0.7, 0.75, 0.8, 0.85), max_iters=20),
    "flooding": dict(schedule="flooding", max_iters=20),
    "scms": dict(schedule="flooding", self_correction=True, max_iters=20),
    "soft-layered": dict(normalization=0.75, soft_output=True, max_iters=20),
}


@pytest.mark.parametrize("snr_db", SNRS)
@pytest.mark.parametrize("mode", list(MIN_SUM))
def test_torch_decode_matches_jnp(mode, snr_db):
    mine, theirs = _small()
    kw = MIN_SUM[mode]
    _, llr = _llr(mine, snr_db, seed=int(snr_db) + 3)
    got = bp.decode_qc(mine, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_equal(got, _reference(theirs, kw, llr), posteriors="soft" in mode)
    if snr_db == SNRS[1]:
        assert not got.converged.all()


def test_sum_product_matches_jnp_in_hard_outputs():
    """Sum-product: torch's exp/log1p are not XLA's, so the two agree in
    bits and converged flags at a converging point, iterations within 1."""
    mine, theirs = _small()
    kw = dict(algorithm="sum-product", max_iters=20)
    _, llr = _llr(mine, 5.0, seed=11)
    got = bp.decode_qc(mine, DecoderConfig(**kw), torch.from_numpy(llr))
    want = _reference(theirs, kw, llr)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1
    assert got.converged.all()


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_bf16_decodes_to_the_true_codeword(schedule):
    """bf16 by the reference's policy: at a clean point every frame of both
    packages converges to the true information bits."""
    mine, theirs = _small()
    kw = dict(schedule=schedule, normalization=0.75, msg_dtype="bfloat16", max_iters=20)
    u, llr = _llr(mine, 7.0, seed=13)
    got = bp.decode_qc(mine, DecoderConfig(**kw), torch.from_numpy(llr))
    want = _reference(theirs, kw, llr)
    pos = mine.info_positions
    for res in (got, want):
        assert np.asarray(res.converged).all()
        np.testing.assert_array_equal(np.asarray(res.bits)[:, pos], u)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_torch_decode_matches_kernel_a_interpret(schedule):
    """The plain version against the TPU kernel A itself (its xor
    butterfly, Pallas interpret mode), as tests/test_rs_ldpc.py calls it."""
    mine, theirs = _small()
    cfg = dict(schedule=schedule, normalization=0.75)
    _, llr = _llr(mine, 3.5, seed=4, batch=8)
    got = bp.decode_qc(mine, DecoderConfig(**cfg), torch.from_numpy(llr))
    want = decode_qc_pallas(theirs, ref.DecoderConfig(**cfg), jnp.asarray(llr), True)
    for f in ("bits", "iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_default_code_decode_matches_jnp(default_codes):
    mine, theirs = default_codes
    kw = dict(normalization=0.75, max_iters=20)
    _, llr = _llr(mine, 5.5, seed=21, batch=4)
    got = bp.decode_qc(mine, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_equal(got, _reference(theirs, kw, llr))


# -- encoder, dispatch, interop, CLI -------------------------------------------

def test_encoder_uses_the_codes_information_set():
    mine, theirs = _small()
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, size=(8, mine.k_info), dtype=np.uint8)
    enc = Encoder(mine, device="cpu")
    assert enc.mats is mine.encoder_matrices
    cw = enc(torch.from_numpy(u)).numpy()
    assert not mine.syndrome(cw).any()
    np.testing.assert_array_equal(cw, ref_encode_numpy(theirs.encoder_matrices, u))
    np.testing.assert_array_equal(cw[:, mine.info_positions], u)


def test_decoder_dispatch():
    code = rs_ldpc(*SMALL)
    dec = Decoder(code, DecoderConfig(), device="cpu")
    assert dec.implementation == "torch"
    u, llr = _llr(code, 9.0, seed=6, batch=4)
    res = dec(llr)
    np.testing.assert_array_equal(dec.info_bits(res).numpy(), u)
    assert cuda_bp.supported(code) and cuda_bp.supported(code, DecoderConfig(
        schedule="flooding", self_correction=True))
    assert not cuda_long.supported(code) and not cuda_long.supported(rs_ldpc())
    too_many = rs_ldpc(s=6, gamma=9, rho=32)  # 288 xor blocks
    assert too_many.num_blocks > 256 and not cuda_bp.supported(too_many)
    assert cuda_bp.group_slots(code) == 0


def test_interop_carries_rs_ldpc():
    mine, theirs = _small()
    carried = interop.code_from_reference(theirs)
    assert type(carried) is type(mine) and carried.group == "xor"
    assert carried.name == mine.name
    np.testing.assert_array_equal(carried.shifts, mine.shifts)


def test_waterfall_cli_rs_ldpc(capsys):
    assert cli.main(["waterfall", "--family", "rs_ldpc", "--n", "1024", "--snr", "6",
                     "--batch", "8", "--target-errors", "1", "--max-frames", "8",
                     "--max-iters", "10", "--device", "cpu"]) == 0
    assert "snr=+6.00 frames=8" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="32"):
        cli.main(["waterfall", "--family", "rs_ldpc", "--n", "2000", "--device", "cpu"])
