"""The long-code slice against the JAX package on the CPU.

* The long-code kernel's plain version (``cuda_long.decode_qc_long_plain``)
  is bit-exact with the TPU kernel ``decode_qc_zlane`` run in interpret mode,
  on the small random QC codes of the reference's tests/test_zlane.py.
* ``cuda_long.supported`` agrees with ``zlane_supported`` except where the
  port refuses on purpose for now.
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


def _all_zero_llr(n, batch, seed):
    """Consistent Gaussian LLRs of the all-zero codeword (mean m, variance
    2m), with m spread over the batch from hopeless to easy, so that some
    frames converge early and others run out of iterations."""
    rng = np.random.default_rng(seed)
    m = np.linspace(1.0, 8.0, batch, dtype=np.float32)[:, None]
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
}


@pytest.mark.parametrize("case", list(SUPPORT_CASES))
def test_supported_agrees_with_zlane(case):
    rcode, kw = SUPPORT_CASES[case]
    verdict = zlane_supported(rcode, ref.DecoderConfig(**kw))
    code = interop.code_from_reference(rcode)
    assert cuda_long.supported(code, DecoderConfig(**kw)) is verdict


#: served by the TPU kernel, refused by the port's kernel C on purpose
#: until a later slice ports that mode (ROADMAP Queue 2); the torch path and
#: kernel A serve them
REFUSED_ON_PURPOSE = {
    "sum-product": (_random_qc(128), dict(algorithm="sum-product")),
    "soft-output": (_random_qc(128), dict(soft_output=True)),
}


@pytest.mark.parametrize("case", list(REFUSED_ON_PURPOSE))
def test_supported_refuses_on_purpose(case):
    rcode, kw = REFUSED_ON_PURPOSE[case]
    assert zlane_supported(rcode, ref.DecoderConfig(schedule="layered", **kw))
    code = interop.code_from_reference(rcode)
    # the code is served; the configuration is refused
    assert cuda_long.supported(code)
    assert not cuda_long.supported(code, DecoderConfig(**kw))


def test_supported_refuses_unserved_configs():
    code = nr.nr_code(64, 1)
    assert cuda_long.supported(code, DecoderConfig())
    for bad in (dict(soft_output=True), dict(msg_dtype="bfloat16")):
        cfg = object.__new__(DecoderConfig)  # past __post_init__'s refusals
        for f in DecoderConfig.__dataclass_fields__.values():
            object.__setattr__(cfg, f.name, bad.get(f.name, f.default))
        assert not cuda_long.supported(code, cfg), bad
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
    """The library's name hashes every source: editing either kernel names
    a new library, so a stale build is never loaded."""
    before = _build._lib_path().name
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build._CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    assert _build._lib_path().name == before
    for name in _build.SOURCES:
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
