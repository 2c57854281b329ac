"""The port's native host library (``myldpccppapi_torch/native``) against
the JAX package's (``myldpccppapi_tpu.native``), bit for bit: byte
packing, the packed GF(2) kernels, the four C++ goldens; the flooding
golden against the port's NumPy golden; ``codes/gf2.py``'s dispatch above
its thresholds; the build's refusals; and the small functions this slice
adds (``gf2_solve``, ``snr_db_from_ebn0_db``, tensor ``pack_bits``)."""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import native as ref_native
from myldpccppapi_tpu.codes import gf2 as ref_gf2
from myldpccppapi_tpu.codes.dvbs2 import dvbs2_ira_qc as ref_dvbs2_ira_qc
from myldpccppapi_tpu.codes.rs_ldpc import rs_ldpc as ref_rs_ldpc
from myldpccppapi_tpu.ops import channel as ref_channel
from myldpccppapi_tpu.ops import packing as ref_packing

from myldpccppapi_torch import native
from myldpccppapi_torch.codes import dvbs2_ira_qc, encode_numpy, gf2, rs_ldpc, ru_precompute, wimax
from myldpccppapi_torch.ops import channel, golden, packing
from myldpccppapi_torch.ops.bp import decode_flooding, decode_layered
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CODE = wimax(576, "3/4B")
REF_CODE = ref.wimax(576, "3/4B")
GOLDENS = ("decode_golden_native", "decode_golden_layered_native",
           "decode_golden_flooding_native", "decode_golden_sp_ref_native")


def _llr(snr_db, batch, seed, code=CODE):
    """BPSK/AWGN channel values y of random codewords, from numpy: what the
    reference's ``Coder`` feeds its goldens (min-sum is scale-invariant;
    the sum-product golden scales y by 8 = 2/sigma^2 itself)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    return (1 - 2 * c.astype(np.float32)
            + sigma * rng.standard_normal(c.shape).astype(np.float32)).astype(np.float32)


def _zero_cw_llr(n, snr_db, batch, seed):
    """LLRs of the all-zero codeword (a codeword of every linear code)."""
    rng = np.random.default_rng(seed)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 + sigma * rng.standard_normal((batch, n)).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _equal(got, want):
    for name, a, b in zip(("bits", "converged", "iterations"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def masked():
    """DVB-S2 16200 r1/2 in QC form: multi-edge cells and a row-masked
    wrap circulant, in both packages."""
    return dvbs2_ira_qc(16200, "1/2"), ref_dvbs2_ira_qc(16200, "1/2")


# -- byte packing and GF(2) ---------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 7), (1,)])
def test_pack_unpack_equal_reference(shape):
    rng = np.random.default_rng(len(shape))
    data = rng.integers(0, 256, size=shape, dtype=np.uint8)
    bits = native.unpack_bits(data)
    np.testing.assert_array_equal(bits, ref_native.unpack_bits(data))
    np.testing.assert_array_equal(bits, packing.unpack_bits_np(data))
    np.testing.assert_array_equal(native.pack_bits(bits), ref_native.pack_bits(bits))
    np.testing.assert_array_equal(native.pack_bits(bits), data)
    with pytest.raises(ValueError, match="multiple of 8"):
        native.pack_bits(bits[..., :-1])


@pytest.mark.parametrize("shape", [(40, 70), (120, 250), (300, 300), (257, 129)])
def test_rref_equal_reference(shape):
    m = np.random.default_rng(shape[0]).integers(0, 2, size=shape, dtype=np.uint8)
    got, want = native.rref_packed(m), ref_native.rref_packed(m)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, gf2.rref_plain(m)):
        np.testing.assert_array_equal(a, b)


def _invertible(n, seed):
    rng = np.random.default_rng(seed)
    while True:
        a = rng.integers(0, 2, size=(n, n), dtype=np.uint8)
        if len(gf2.rref_plain(a)[1]) == n:
            return a


@pytest.mark.parametrize("n", [8, 96, 300])
def test_inv_equal_reference(n):
    a = _invertible(n, n)
    got = native.inv_packed(a)
    np.testing.assert_array_equal(got, ref_native.inv_packed(a))
    np.testing.assert_array_equal(got, gf2.inv_plain(a))
    np.testing.assert_array_equal(gf2.matmul_plain(a, got), np.eye(n, dtype=bool))


@pytest.mark.parametrize("n", [8, 300])
def test_singular_inv_raises(n):
    a = _invertible(n, 7)
    a[-1] = a[0]
    for fn in (native.inv_packed, ref_native.inv_packed, gf2.gf2_inv, gf2.inv_plain):
        with pytest.raises(np.linalg.LinAlgError):
            fn(a)


@pytest.mark.parametrize("shapes", [((70, 130), (130, 90)), ((300, 200), (200, 130)),
                                    ((1, 64), (64, 1))])
def test_matmul_equal_reference(shapes):
    rng = np.random.default_rng(shapes[0][0])
    a = rng.integers(0, 2, size=shapes[0], dtype=np.uint8)
    b = rng.integers(0, 2, size=shapes[1], dtype=np.uint8)
    got = native.matmul_packed(a, b)
    np.testing.assert_array_equal(got, ref_native.matmul_packed(a, b))
    np.testing.assert_array_equal(got, gf2.matmul_plain(a, b))


@pytest.fixture(scope="module")
def dense_h():
    return {"wimax 2304 r1/2": (wimax(2304, "1/2").h_dense(),
                                ref.wimax(2304, "1/2").h_dense()),
            "rs_ldpc()": (rs_ldpc().h_dense(), ref_rs_ldpc().h_dense())}


@pytest.mark.parametrize("name", ["wimax 2304 r1/2", "rs_ldpc()"])
def test_dense_h_equal_reference(dense_h, name):
    """RREF of H, the inverse of H's pivot columns and the product of H with
    its transpose, on the two codes' dense parity-check matrices: the
    library, the reference's library and the plain versions agree."""
    h, ref_h = dense_h[name]
    np.testing.assert_array_equal(h, ref_h)
    rr, piv = native.rref_packed(h)
    for a, b in zip((rr, piv), ref_native.rref_packed(h)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((rr, piv), gf2.rref_plain(h)):
        np.testing.assert_array_equal(a, b)
    rows = gf2.rref_plain(h.T)[1]  # independent rows of H
    square = h[rows][:, piv]
    inv = native.inv_packed(square)
    np.testing.assert_array_equal(inv, ref_native.inv_packed(square))
    np.testing.assert_array_equal(inv, gf2.inv_plain(square))
    prod = native.matmul_packed(h, h.T)
    np.testing.assert_array_equal(prod, ref_native.matmul_packed(h, h.T))
    np.testing.assert_array_equal(prod, gf2.matmul_plain(h, h.T))


@pytest.mark.parametrize("fn", ["gf2_matmul", "gf2_inv", "gf2_solve", "gf2_rref", "gf2_rank"])
def test_gf2_above_thresholds_equal_reference(fn, monkeypatch):
    """The port's ``codes/gf2.py`` above its native thresholds (the library
    runs: its plain bodies are made to fail) equals the JAX package's."""
    rng = np.random.default_rng(11)
    a = _invertible(300, 3)
    b = rng.integers(0, 2, size=(300, 80), dtype=np.uint8)
    m = rng.integers(0, 2, size=(280, 400), dtype=np.uint8)
    args = {"gf2_matmul": (m, rng.integers(0, 2, size=(400, 60), dtype=np.uint8)),
            "gf2_inv": (a,), "gf2_solve": (a, b), "gf2_rref": (m,), "gf2_rank": (m,)}[fn]
    for plain in ("matmul_plain", "inv_plain", "rref_plain"):
        monkeypatch.setattr(gf2, plain, lambda *_, p=plain: pytest.fail(f"{p} ran"))
    got, want = getattr(gf2, fn)(*args), getattr(ref_gf2, fn)(*args)
    if fn == "gf2_rref":
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(got, want)


def test_gf2_below_thresholds_runs_plain(monkeypatch):
    rng = np.random.default_rng(5)
    a = _invertible(40, 5)
    b = rng.integers(0, 2, size=(40, 9), dtype=np.uint8)
    for name in ("matmul_packed", "inv_packed", "rref_packed"):
        monkeypatch.setattr(native, name, lambda *_: pytest.fail("native ran"))
    np.testing.assert_array_equal(gf2.gf2_solve(a, b), ref_gf2.gf2_solve(a, b))
    np.testing.assert_array_equal(gf2.matmul_plain(a, gf2.gf2_solve(a, b)), b.astype(bool))
    assert gf2.gf2_rank(b) == ref_gf2.gf2_rank(b)


# -- the goldens --------------------------------------------------------------

@pytest.mark.parametrize("snr_db", [5.0, 3.0])
@pytest.mark.parametrize("fn", GOLDENS)
def test_goldens_equal_reference(fn, snr_db):
    llr = _llr(snr_db, 256, seed=int(snr_db))
    got = getattr(native, fn)(CODE, llr)
    want = getattr(ref_native, fn)(REF_CODE, llr)
    _equal(got, want)
    if snr_db == 5.0:
        assert got[1].sum() > len(llr) // 2
    else:
        assert not got[1].all()  # capped frames: the trajectories matter


@pytest.mark.parametrize("fn,kw", [
    ("decode_golden_native", dict(normalization=0.8, offset=0.1)),
    ("decode_golden_layered_native", dict(normalization=0.85, offset=0.05)),
    ("decode_golden_flooding_native", dict(normalization=0.75)),
    ("decode_golden_flooding_native", dict(self_correction=True)),
    ("decode_golden_sp_ref_native", dict(scale=4.0)),
])
def test_goldens_equal_reference_masked_multi_edge(masked, fn, kw):
    code, ref_code = masked
    llr = _zero_cw_llr(code.n, 0.6, 8, seed=2)
    got = getattr(native, fn)(code, llr, max_iters=10, **kw)
    _equal(got, getattr(ref_native, fn)(ref_code, llr, max_iters=10, **kw))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_block_goldens_equal_torch_path_on_xor_code(schedule):
    """RS-LDPC aligns blocks by XOR: the layered plan follows the code's
    group, so the block goldens equal the torch path there (the
    reference's plan rolls every block cyclically)."""
    code = rs_ldpc(4, 4, 8)
    llr = _zero_cw_llr(code.n, 2.0, 64, seed=4)
    cfg = DecoderConfig(schedule=schedule, normalization=0.75, max_iters=20)
    fn = decode_layered if schedule == "layered" else decode_flooding
    res = fn(code, cfg, torch.from_numpy(llr))
    golden_fn = (native.decode_golden_layered_native if schedule == "layered"
                 else native.decode_golden_flooding_native)
    got = golden_fn(code, llr, max_iters=20, normalization=0.75)
    _equal(got, (res.bits.numpy(), res.converged.numpy(), res.iterations.numpy()))
    assert 0 < got[1].sum() < len(llr)


def test_flooding_golden_against_numpy_golden():
    """The C++ flooding min-sum (f32) against the port's NumPy golden
    (f64): convergence and iterations equal, bits equal on converged
    frames (the two differ only on capped, chaotic trajectories)."""
    llr = _llr(4.5, 16, seed=9)
    nb, nc, ni = native.decode_golden_native(CODE, llr, max_iters=20)
    gb, gc, gi = golden.decode_golden(CODE, llr, max_iters=20)
    np.testing.assert_array_equal(nc, gc)
    np.testing.assert_array_equal(ni, gi)
    np.testing.assert_array_equal(nb[gc], gb[gc])
    assert 0 < gc.sum() < len(gc)


@pytest.mark.parametrize("snr_db", [5.0, 3.0])
def test_flooding_golden_equals_numpy_golden_in_f32(snr_db):
    """In f32 the NumPy golden adds the posterior in the C++ golden's (row)
    order: every field of every frame equal, capped frames too."""
    llr = _llr(snr_db, 24, seed=20 + int(snr_db))
    got = native.decode_golden_native(CODE, llr, max_iters=12)
    _equal(got, golden.decode_golden(CODE, llr, max_iters=12, dtype=np.float32))
    assert not got[1].all()


def test_plan_cache_is_per_object():
    """Plans are held per live code object, never by a reusable id."""
    a = wimax(576, "1/2")
    plan = native._layered_plan(a)
    assert native._layered_plan(a) is plan
    b = wimax(576, "3/4B")
    assert native._layered_plan(b)[1].shape != plan[1].shape
    n = len(native._LAYERED_PLANS)
    del a
    assert len(native._LAYERED_PLANS) == n - 1


def test_golden_refuses_wrong_width():
    with pytest.raises(ValueError, match="576"):
        native.decode_golden_native(CODE, np.zeros((2, 575), np.float32))


# -- the build ----------------------------------------------------------------

@pytest.mark.parametrize("fault", ["no compiler", "missing binary", "bad flag"])
def test_failed_build_raises(fault, monkeypatch, tmp_path):
    """No compiler, or one that fails, raises RuntimeError; nothing falls
    back."""
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    if fault == "no compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    elif fault == "missing binary":
        monkeypatch.setattr(native, "find_cxx", lambda: str(tmp_path / "no-g++"))
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+|compiler"):
            native.load()
        with pytest.raises(RuntimeError):
            native.decode_golden_native(CODE, np.zeros((1, CODE.n), np.float32))
    finally:
        native.load.cache_clear()
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == []


def test_import_builds_nothing_and_leaves_jax_out():
    code = (
        "import os, sys\n"
        "from myldpccppapi_torch import native\n"
        "before = sorted(os.listdir(native._BUILD)) if native._BUILD.exists() else []\n"
        "import myldpccppapi_torch, myldpccppapi_torch.bench, myldpccppapi_torch.cli\n"
        "import myldpccppapi_torch.codes.gf2\n"
        "after = sorted(os.listdir(native._BUILD)) if native._BUILD.exists() else []\n"
        "assert before == after, (before, after)\n"
        "assert native.load.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'myldpccppapi_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr


# -- the small functions ------------------------------------------------------

@pytest.mark.parametrize("rate,bps", [(0.5, 1), (0.75, 2), (5 / 6, 4), (1723 / 2048, 6),
                                      (1 / 3, 8)])
def test_snr_db_from_ebn0_db_equals_reference(rate, bps):
    """f32 out; XLA's f32 log may differ from torch's in the last place of
    the log term: 1e-6 absolute on values of a few dB."""
    ebn0 = np.linspace(-2.0, 10.0, 25, dtype=np.float32)
    got = channel.snr_db_from_ebn0_db(torch.from_numpy(ebn0), rate, bps)
    want = np.asarray(ref_channel.snr_db_from_ebn0_db(ebn0, rate, bps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert channel.snr_db_from_ebn0_db(3.0, rate, bps).dtype == torch.float32


@pytest.mark.parametrize("shape", [(54,), (3, 16), (2, 3, 5)])
def test_tensor_packing_equals_reference(shape):
    data = np.random.default_rng(sum(shape)).integers(0, 256, size=shape, dtype=np.uint8)
    bits = packing.unpack_bits(torch.from_numpy(data))
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(ref_packing.unpack_bits(jnp.asarray(data))))
    packed = packing.pack_bits(bits)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(ref_packing.pack_bits(jnp.asarray(bits.numpy()))))
    np.testing.assert_array_equal(packed.numpy(), data)
    with pytest.raises(ValueError, match="multiple of 8"):
        packing.pack_bits(bits[..., :-1])
    with pytest.raises(ValueError, match="multiple of 8"):
        ref_packing.pack_bits(jnp.asarray(bits.numpy())[..., :-1])
