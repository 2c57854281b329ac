"""The long-code slice against the JAX package on the CPU.

* The long-code kernel's plain version (``cuda_long.decode_qc_long_plain``)
  is bit-exact with the TPU kernel ``decode_qc_zlane`` run in interpret mode,
  on the small random QC codes of the reference's tests/test_zlane.py.
* Its min-sum soft output (the latched posteriors of every frame) is
  bit-exact with the TPU kernel in interpret mode and with the jnp path on
  NR with LLR-0 punctured columns; its sum-product, whose ``exp``/
  ``log1p`` are torch's and not XLA's, agrees at a converging point:
  equal bits and converged flags, iterations within 1.
* ``cuda_long.supported`` agrees with ``zlane_supported``.
* The whole NR slice — code, rate-matched LLRs, ``Decoder`` — is bit-exact
  with the JAX ``Decoder`` at ``nr_code(64, 1)``.
The CUDA kernel itself runs only on a card (chip_smoke.py)."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import nr as ref_nr
from myldpccppapi_tpu.codes.dvbs2 import dvbs2 as ref_dvbs2
from myldpccppapi_tpu.codes.qc import QCCode as RefQCCode
from myldpccppapi_tpu.ops.pallas_zlane import decode_qc_zlane, zlane_supported

from myldpccppapi_torch import Decoder, DecoderConfig, interop
from myldpccppapi_torch.codes import nr, tables
from myldpccppapi_torch.ops import _build, cuda_long

torch.set_num_threads(1)

FIELDS = ("bits", "converged", "iterations", "total_iters")


def _random_qc(z, m_b=4, n_b=9, seed=7, extra=False, masked=False):
    """tests/test_zlane.py::_random_qc: a small QC code with a staircase
    parity part, optionally with a multi-edge cell and a masked row."""
    rng = np.random.default_rng(seed)
    k_b = n_b - m_b
    base = np.full((m_b, n_b), -1, dtype=np.int32)
    for i in range(m_b):
        cols = rng.choice(k_b, size=3, replace=False)
        for j in cols:
            base[i, j] = int(rng.integers(0, z))
        base[i, k_b + i] = 0
        if i + 1 < m_b:
            base[i + 1, k_b + i] = int(rng.integers(0, z))
    extra_blocks = masked_rows = None
    if extra:
        i, j = 1, int(np.nonzero(base[1][:k_b] >= 0)[0][0])
        extra_blocks = ((i, j, (int(base[i, j]) + 5) % z),)
    if masked:
        i, j, s = 0, k_b + m_b - 1, z - 1
        base[i, j] = s
        masked_rows = (((i, j, s), (0,)),)
    return RefQCCode(name=f"test_z{z}", base=base, z=z,
                     extra_blocks=extra_blocks, masked_rows=masked_rows)


def _assert_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


WEIGHTS = {"alpha0.75": 0.75, "per-layer": (0.7, 0.8, 0.75, 0.85)}


def _all_zero_llr(n, batch, seed, lo=1.0):
    """Consistent Gaussian LLRs of the all-zero codeword (mean m, variance
    2m), with m spread over the batch from ``lo`` (hopeless at 1.0) to
    easy, so that some frames converge early and others run out of
    iterations."""
    rng = np.random.default_rng(seed)
    m = np.linspace(lo, 8.0, batch, dtype=np.float32)[:, None]
    return (m + np.sqrt(2 * m) * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("batch", [5, 16])
@pytest.mark.parametrize("z", [128, 150])
def test_plain_matches_zlane_kernel(z, batch, weights, early_exit):
    """z a lane multiple (128) and padded (150); a batch that is and is not
    a multiple of the TPU kernel's 8-codeword tile."""
    rcode = _random_qc(z)
    kw = dict(normalization=WEIGHTS[weights], max_iters=12,
              early_exit=early_exit)
    llr = _all_zero_llr(rcode.n, batch, seed=z + batch)
    want = decode_qc_zlane(rcode, ref.DecoderConfig(schedule="layered", **kw),
                           jnp.asarray(llr), True)
    code = interop.code_from_reference(rcode)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw),
                                   torch.from_numpy(llr))
    _assert_equal(got, want)
    conv = got.converged.numpy()
    assert 0 < conv.sum() < batch  # both latched and straggling frames
    if not early_exit:
        assert int(got.total_iters) == 12


def _assert_soft_equal(got, want):
    _assert_equal(got, want)
    assert got.posteriors is not None and got.posteriors.dtype == torch.float32
    np.testing.assert_array_equal(got.posteriors.numpy(), np.asarray(want.posteriors))


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("structure", ["z128", "z150-multi-edge-masked"])
def test_plain_soft_output_matches_zlane_kernel(structure, early_exit):
    """The TPU kernel's latched posterior output (tests/test_zlane.py
    test_zlane_soft_output_bitexact): plain, padded-z, multi-edge and
    masked structures at a mixed-convergence point."""
    special = structure != "z128"
    rcode = _random_qc(150 if special else 128, extra=special, masked=special)
    kw = dict(normalization=0.75, max_iters=10, soft_output=True,
              early_exit=early_exit)
    llr = _all_zero_llr(rcode.n, 16, seed=21)
    want = decode_qc_zlane(rcode, ref.DecoderConfig(schedule="layered", **kw),
                           jnp.asarray(llr), True)
    code = interop.code_from_reference(rcode)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_soft_equal(got, want)
    conv = got.converged.numpy()
    assert 0 < conv.sum() < len(conv)
    # the hard decisions follow the soft output
    np.testing.assert_array_equal((got.posteriors <= 0).numpy(), got.bits.numpy() == 1)


def _nr_llr(z, bg, batch, snr_db, seed):
    """Rate-matched (rv0, full buffer) BPSK/AWGN LLRs of random NR
    codewords, de-rate-matched: LLR 0 in the punctured columns."""
    code = nr.nr_code(z, bg)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    tx = nr.rate_match_bits(code, nr.triangular_encode_fn(code)(torch.from_numpy(u)),
                            code.n - code.punctured_front).numpy()
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * tx.astype(np.float32) + sigma * rng.standard_normal(tx.shape).astype(np.float32)
    return nr.rate_match_llr(code, torch.from_numpy((y * np.float32(2 / sigma**2))))


@pytest.mark.parametrize("bg,snr_db,early_exit", [(1, -0.75, True), (1, -0.75, False),
                                                  (2, -3.0, True)])
def test_plain_soft_output_matches_jnp_on_nr(bg, snr_db, early_exit):
    """Min-sum soft output on NR z=64, the 2Z punctured columns at LLR 0:
    bits, iterations and the posteriors of every frame equal the jnp
    path's."""
    llr = _nr_llr(SLICE_Z, bg, 8, snr_db, seed=65 + bg)
    assert (llr[:, :2 * SLICE_Z] == 0).all()
    kw = dict(normalization=0.8, max_iters=10, soft_output=True, early_exit=early_exit)
    got = Decoder(nr.nr_code(SLICE_Z, bg), DecoderConfig(**kw), device="cpu")(llr)
    want = ref.Decoder(ref_nr.nr_code(SLICE_Z, bg),
                       ref.DecoderConfig(implementation="jnp", **kw))(jnp.asarray(llr.numpy()))
    _assert_soft_equal(got, want)
    conv = got.converged.numpy()
    assert 0 < conv.sum() < len(conv)


def _assert_sp_agrees(got, want):
    """Sum-product against XLA's: equal bits and converged flags,
    iterations within 1 (torch's exp/log1p are not XLA's)."""
    for f in ("bits", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1


@pytest.mark.parametrize("structure,soft", [("z128", False),
                                            ("z150-multi-edge-masked", True)])
def test_plain_sum_product_agrees_with_zlane_kernel(structure, soft):
    special = structure != "z128"
    rcode = _random_qc(150 if special else 128, extra=special, masked=special)
    kw = dict(algorithm="sum-product", max_iters=8, soft_output=soft)
    llr = _all_zero_llr(rcode.n, 8, seed=22, lo=4.0)
    want = decode_qc_zlane(rcode, ref.DecoderConfig(schedule="layered", **kw),
                           jnp.asarray(llr), True)
    code = interop.code_from_reference(rcode)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_sp_agrees(got, want)
    assert got.converged.all()  # a converging point
    if soft:
        # the posteriors are not compared in value: phi(total - phi(|q|))
        # near convergence cancels to a tiny argument, where one ulp of
        # exp/log1p moves the result by up to ~1e-2 relative; their signs
        # are the reference's
        np.testing.assert_array_equal(got.posteriors.numpy() <= 0,
                                      np.asarray(want.posteriors) <= 0)


def test_plain_sum_product_soft_agrees_with_jnp_on_nr():
    llr = _nr_llr(SLICE_Z, 1, 8, 1.0, seed=67)
    kw = dict(algorithm="sum-product", max_iters=10, soft_output=True)
    got = Decoder(nr.nr_code(SLICE_Z, 1), DecoderConfig(**kw), device="cpu")(llr)
    want = ref.Decoder(ref_nr.nr_code(SLICE_Z, 1),
                       ref.DecoderConfig(implementation="jnp", **kw))(jnp.asarray(llr.numpy()))
    _assert_sp_agrees(got, want)
    assert got.converged.all()
    np.testing.assert_array_equal(got.posteriors.numpy() <= 0, got.bits.numpy() == 1)


def test_long_kernel_serves_soft_output_and_sum_product(monkeypatch):
    """On a CUDA device, soft output and sum-product on NR BG1 Z=384 resolve
    to the long-code kernel in both placements (its fit query, which needs
    the card, is stubbed); soft output with triage, SCMS on it, and the
    flooding schedule on a long code stay refused."""
    from myldpccppapi_torch import decoder

    code = nr.nr_code(384, 1)
    cuda = torch.device("cuda", 0)
    configs = (DecoderConfig(soft_output=True),
               DecoderConfig(algorithm="sum-product"),
               DecoderConfig(algorithm="sum-product", soft_output=True,
                             syndrome_mode="lazy"))
    for place in (cuda_long.SHARED, cuda_long.GLOBAL):
        monkeypatch.setattr(cuda_long, "placement",
                            lambda c, i, itemsize=4, p=place: p)
        for cfg in configs:
            assert cuda_long.supported(code, cfg, cuda)
            assert decoder._implementation(code, cfg, cuda) == "cuda_long"
    with pytest.raises(ValueError, match="no CUDA kernel serves"):
        decoder._implementation(code, DecoderConfig(schedule="flooding"), cuda)
    with pytest.raises(ValueError, match="triage"):
        Decoder(code, DecoderConfig(soft_output=True, triage_iters=5), device="cpu")
    with pytest.raises(ValueError, match="self_correction"):
        Decoder(code, DecoderConfig(schedule="flooding", self_correction=True,
                                    implementation="cuda_long"), device="cpu")


SUPPORT_CASES = {
    "z128": (_random_qc(128), {}),
    "z150": (_random_qc(150), {}),
    "z32": (_random_qc(32), {}),
    "flooding": (_random_qc(128), dict(schedule="flooding")),
    "nr_bg1_z384": (ref_nr.nr_code(384, 1), {}),
    "nr_bg2_z384": (ref_nr.nr_code(384, 2), {}),
    "nr_bg1_z208": (ref_nr.nr_code(208, 1), {}),
    "nr_bg1_z64": (ref_nr.nr_code(64, 1), {}),
    "nr_bg1_z48": (ref_nr.nr_code(48, 1), {}),
    "per-layer": (_random_qc(128), dict(normalization=(0.7, 0.8, 0.75, 0.85))),
    "offset": (_random_qc(128), dict(offset=0.25)),
    # kernel C's multi-edge, masked-row and lazy modes (the DVB-S2 slice)
    "multi-edge": (_random_qc(150, extra=True), {}),
    "masked-row": (_random_qc(150, masked=True), {}),
    "dvbs2-16200": (ref_dvbs2(16200, "1/2"), dict(syndrome_mode="lazy")),
    # kernel C's sum-product and soft-output modes (the soft receive slice)
    "sum-product": (_random_qc(128), dict(algorithm="sum-product")),
    "soft-output": (_random_qc(128), dict(soft_output=True)),
}


@pytest.mark.parametrize("case", list(SUPPORT_CASES))
def test_supported_agrees_with_zlane(case):
    rcode, kw = SUPPORT_CASES[case]
    verdict = zlane_supported(rcode, ref.DecoderConfig(**kw))
    code = interop.code_from_reference(rcode)
    assert cuda_long.supported(code, DecoderConfig(**kw)) is verdict


def test_supported_refuses_unserved_configs():
    """bf16 messages are the kernel's; a CRC or outer-BCH check is not (the
    kernel is syndrome-only, Decoder wraps it)."""
    code = nr.nr_code(64, 1)
    assert cuda_long.supported(code, DecoderConfig())
    assert cuda_long.supported(code, DecoderConfig(msg_dtype="bfloat16"))
    for bad in (dict(crc="16"), dict(outer=("bch", 16, 12))):
        assert not cuda_long.supported(code, DecoderConfig(**bad)), bad
    assert not cuda_long.supported(np.zeros((2, 4)))


def test_wrapper_refuses_other_devices_and_bad_inputs():
    code = nr.nr_code(64, 1)
    cfg = DecoderConfig()
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_long.decode_qc_long(code, cfg, torch.empty((2, code.n), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        cuda_long.decode_qc_long(code, cfg, torch.zeros((2, code.n),
                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        cuda_long.decode_qc_long(code, cfg, torch.zeros((2, code.n + 1)))
    assert cuda_long.decode_qc_long.launches == 0


def _c_signatures():
    """Argument ctypes of every extern "C" function of csrc/*.cu, read from
    the sources: pointers -> c_void_p, int -> c_int."""
    sigs = {}
    for name in _build.SOURCES:
        src = (_build._CSRC / name).read_text()
        body = src[src.index('extern "C" {'):]
        for m in re.finditer(r"^int (ldpc_\w+)\(([^)]*)\)", body, re.M):
            args = [a.strip() for a in m.group(2).split(",")]
            sigs[m.group(1)] = [ctypes.c_void_p if "*" in a else ctypes.c_int
                                for a in args]
    return sigs


def test_ctypes_signatures_match_the_sources():
    """The loader's argtypes agree with the C declarations, argument by
    argument (a mismatch shows only as a failed or corrupt launch on the
    card)."""
    declared = {name: argtypes for name, (argtypes, _) in _build._SIGNATURES.items()}
    assert declared == _c_signatures()
    assert set(_build.SOURCES) == {p.name for p in _build._CSRC.glob("*.cu")}


def test_library_name_covers_every_source(monkeypatch, tmp_path):
    """The library's name hashes every source and header: editing any of
    them names a new library, so a stale build is never loaded."""
    before = _build._lib_path().name
    assert set(_build.HEADERS) == {p.name for p in _build._CSRC.glob("*.cuh")}
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build._CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    assert _build._lib_path().name == before
    for name in _build.SOURCES + _build.HEADERS:
        path = tmp_path / name
        text = path.read_bytes()
        path.write_bytes(text + b"\n// edited\n")
        assert _build._lib_path().name != before
        path.write_bytes(text)


# -- the slice as a whole ----------------------------------------------------

SLICE_Z = 64
SLICE_CFG = dict(normalization=0.8, max_iters=10)


def test_interop_carries_nr_codes():
    theirs = ref_nr.nr_code(SLICE_Z, 1)
    carried = interop.code_from_reference(theirs)
    mine = nr.nr_code(SLICE_Z, 1)
    assert (carried.name, carried.z, carried.punctured_front) == (
        mine.name, mine.z, mine.punctured_front)
    np.testing.assert_array_equal(carried.base, mine.base)
    for a, b in zip(carried.blocks, mine.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(carried.layer_ptr, mine.layer_ptr)
    assert tables.table_fingerprint(carried.base) == (
        tables.table_fingerprint(mine.base))
    cfg = interop.config_from_reference(
        ref.DecoderConfig(implementation="pallas_zlane", **SLICE_CFG))
    assert cfg == DecoderConfig(implementation="cuda_long", **SLICE_CFG)


def test_nr_decoder_slice_matches_reference():
    """Encode, rate-match (rv0, full buffer), BPSK/AWGN and decode
    nr_code(64, 1) in both packages from the same NumPy draws: the
    de-rate-matched LLRs and the Decoder's results are equal."""
    code, rcode = nr.nr_code(SLICE_Z, 1), ref_nr.nr_code(SLICE_Z, 1)
    rng = np.random.default_rng(64)
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    cw = nr.triangular_encode_fn(code)(torch.from_numpy(u))
    e = code.n - code.punctured_front
    tx = nr.rate_match_bits(code, cw, e).numpy()
    np.testing.assert_array_equal(
        tx, np.asarray(ref_nr.rate_match_bits(rcode, jnp.asarray(cw.numpy()), e)))
    sigma = np.float32(10 ** (0.75 / 20))  # -0.75 dB: near the waterfall
    y = 1 - 2 * tx.astype(np.float32) + sigma * rng.standard_normal(tx.shape).astype(np.float32)
    llr_e = (y * np.float32(2 / sigma**2)).astype(np.float32)
    llr = nr.rate_match_llr(code, torch.from_numpy(llr_e))
    ref_llr = ref_nr.rate_match_llr(rcode, jnp.asarray(llr_e))
    np.testing.assert_array_equal(llr.numpy(), np.asarray(ref_llr))

    dec = Decoder(code, DecoderConfig(**SLICE_CFG), device="cpu")
    assert dec.implementation == "torch"
    got = dec(llr)
    want = ref.Decoder(rcode, ref.DecoderConfig(**SLICE_CFG))(ref_llr)
    _assert_equal(got, want)
    conv = got.converged.numpy()
    assert 0 < conv.sum() < len(conv)
    np.testing.assert_array_equal(dec.info_bits(got)[conv].numpy(), u[conv])


@pytest.mark.parametrize("impl", ["cuda", "cuda_long"])
def test_decoder_kernels_need_a_cuda_device(impl):
    with pytest.raises(ValueError, match="CUDA device"):
        Decoder(nr.nr_code(64, 1), DecoderConfig(implementation=impl),
                device="cpu")


@pytest.mark.parametrize("short_ok,long_ok,want", [
    (True, True, "cuda"),
    (False, True, "cuda_long"),
    (False, False, None),
])
def test_auto_dispatch_order_on_a_cuda_device(monkeypatch, short_ok, long_ok, want):
    """On a CUDA device "auto" takes the short-code kernel, then the
    long-code kernel, in the reference's order, and raises when neither
    serves the code (the kernels' own gates are stubbed here: deciding them
    needs the card)."""
    from myldpccppapi_torch import decoder
    from myldpccppapi_torch.ops import cuda_bp

    monkeypatch.setattr(cuda_bp, "supported", lambda *a: short_ok)
    monkeypatch.setattr(cuda_long, "supported", lambda *a: long_ok)
    code, cuda = nr.nr_code(48, 1), torch.device("cuda")
    if want is None:
        with pytest.raises(ValueError, match="short-code kernel.*long-code kernel"):
            decoder._implementation(code, DecoderConfig(), cuda)
    else:
        assert decoder._implementation(code, DecoderConfig(), cuda) == want
    # an explicit kernel that does not serve the code raises at construction
    for impl, ok in (("cuda", short_ok), ("cuda_long", long_ok)):
        cfg = DecoderConfig(implementation=impl)
        if ok:
            assert decoder._implementation(code, cfg, cuda) == impl
        else:
            with pytest.raises(ValueError, match=f"the '{impl}' kernel does not serve"):
                decoder._implementation(code, cfg, cuda)
    # the CPU and an explicit "torch" never consult the kernels
    assert decoder._implementation(code, DecoderConfig(), torch.device("cpu")) == "torch"
    assert decoder._implementation(
        code, DecoderConfig(implementation="torch"), cuda) == "torch"
