"""The DVB-S2 slice against the JAX package on the CPU.

* ``codes/dvbs2.py``: the same codes (base, extra blocks, masked rows,
  block order, layer pointers), 4-cycle counts, interleave, address-table
  parsing, table fingerprints and IRA encodes as the reference's.
* The long-code kernel's plain version is bit-exact with the TPU kernel
  ``decode_qc_zlane`` in interpret mode on codes with multi-edge cells and
  a masked row; its lazy mode meets the reference's lazy contract, and its
  lazy gate is per codeword.
* The port's CPU ``Decoder`` on dvbs2(16200, "1/2") is bit-exact with the
  JAX ``Decoder`` (jnp), exact and lazy configs alike.
* Entry points default to the card and raise without CUDA.
The CUDA kernel itself runs only on a card (chip_smoke.py)."""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.codes import tables as ref_tables
from myldpccppapi_tpu.codes.qc import QCCode as RefQCCode
from myldpccppapi_tpu.ops.pallas_zlane import decode_qc_zlane

from myldpccppapi_torch import Coder, Decoder, DecoderConfig, Encoder, cli, interop
from myldpccppapi_torch.codes import tables
from myldpccppapi_torch.ops import cuda_launch, cuda_long
from myldpccppapi_torch.sim import make_decode_fn, matmul_encode_fn, sim_step

torch.set_num_threads(1)

# the function of the same name shadows each module in its package
ref_dv = importlib.import_module("myldpccppapi_tpu.codes.dvbs2")
dv = importlib.import_module("myldpccppapi_torch.codes.dvbs2")

FIELDS = ("bits", "converged", "iterations", "total_iters")
#: the 16200 rates whose reference tables draw in seconds (r5/6 takes
#: ~16 s), and 64800 r1/2 (BASELINE config 3)
STRUCTURE_CASES = [(16200, r) for r in dv._SHORT_K_LDPC if r != "5/6"] + [(64800, "1/2")]


def _assert_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def _llr(code, batch, snr_db, seed):
    """[batch, n] float32 LLRs of random codewords (the port's NumPy IRA
    encode) through BPSK/AWGN, all draws from NumPy; and the info bits."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = dv.ira_encode_numpy(code, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return u, (y * np.float32(2 / sigma**2)).astype(np.float32)


# -- code construction ---------------------------------------------------------

@pytest.mark.parametrize("n,rate", STRUCTURE_CASES)
def test_code_structure_matches_reference(n, rate):
    mine, theirs = dv.dvbs2(n, rate), ref_dv.dvbs2(n, rate)
    assert mine.name == theirs.name and mine.z == theirs.z == 360
    np.testing.assert_array_equal(mine.base, theirs.base)
    assert mine.extra_blocks == theirs.extra_blocks
    assert mine.masked_rows == theirs.masked_rows
    for a, b in zip(mine.blocks, theirs.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.layer_ptr, theirs.layer_ptr)
    assert mine.max_row_degree == theirs.max_row_degree


@pytest.mark.parametrize("n,rate,seed", [(16200, "1/2", 1), (16200, "3/4", 2),
                                         (16200, "8/9", 0)])
def test_4cycle_count_matches_reference(n, rate, seed):
    """The vectorised count equals the reference's on tables with cycles."""
    k = dv._k_ldpc(n, rate)
    m = n - k
    rng = np.random.default_rng(seed)
    addrs = [tuple(int(x) for x in rng.choice(m, size=8 if g < 3 else 3, replace=False))
             for g in range(k // 360)]
    want = ref_dv._count_std_4cycles(addrs, k, m)
    assert want > 0
    assert dv._count_std_4cycles(addrs, k, m) == want


@pytest.mark.parametrize("n,rate", [(16200, "1/2"), (64800, "1/2")])
def test_ira_encode_matches_reference(n, rate):
    code, rcode = dv.dvbs2(n, rate), ref_dv.dvbs2(n, rate)
    u = np.random.default_rng(n).integers(0, 2, size=(3, code.k), dtype=np.uint8)
    want = ref_dv.ira_encode_numpy(rcode, u)
    np.testing.assert_array_equal(dv.ira_encode_numpy(code, u), want)
    got = dv.ira_encode_fn(code)(torch.from_numpy(u))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if n == 16200:  # the reference's jnp encoder (its tests pin it to NumPy)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(ref_dv.ira_encode_fn(rcode))(jnp.asarray(u))), want)
    assert not code.syndrome(want).any()


def test_std_interleave_matches_reference_and_round_trips():
    code = dv.dvbs2(16200, "1/2")
    perm = dv.std_interleave(code.n, code.k)
    np.testing.assert_array_equal(perm, ref_dv.std_interleave(code.n, code.k))
    assert sorted(perm) == list(range(code.n))
    u = np.random.default_rng(3).integers(0, 2, size=(2, code.k), dtype=np.uint8)
    internal = dv.ira_encode_numpy(code, u)
    std = internal[..., perm]
    np.testing.assert_array_equal(std[..., : code.k], u)
    np.testing.assert_array_equal(std[..., np.argsort(perm)], internal)


def test_parse_address_table_round_trips():
    table = dv.synthetic_address_table(16200, "2/3")
    text = "# EN 302 307-style table\nrow addresses\n" + "\n".join(
        (", " if i % 2 else "; ").join(str(a) for a in row) + "  % group"
        for i, row in enumerate(table))
    parsed = dv.parse_address_table(text)
    assert parsed == table == ref_dv.parse_address_table(text)
    given = dv.dvbs2(16200, "2/3", addresses=parsed)
    np.testing.assert_array_equal(given.base, dv.dvbs2(16200, "2/3").base)
    assert given.extra_blocks == dv.dvbs2(16200, "2/3", addresses="legacy").extra_blocks
    with pytest.raises(ValueError, match="negative"):
        dv.parse_address_table("1 2 -3")
    with pytest.raises(ValueError, match="no address-table rows"):
        dv.parse_address_table("# nothing\n")
    with pytest.raises(ValueError, match="groups"):
        dv.dvbs2(16200, "1/2", addresses=parsed)


@pytest.mark.parametrize("n,rate", [(16200, "1/2"), (16200, "1/3"), (64800, "1/2")])
def test_address_table_fingerprints_match_reference(n, rate):
    """Designed (16200 r1/2, r1/3) and synthetic (64800 r1/2) tables
    fingerprint identically in both packages."""
    from myldpccppapi_torch.codes.dvbs2_designed import DESIGNED_ADDRESSES
    from myldpccppapi_tpu.codes.dvbs2_designed import DESIGNED_ADDRESSES as REF_DESIGNED

    mine = DESIGNED_ADDRESSES.get((n, rate)) or dv.synthetic_address_table(n, rate)
    theirs = REF_DESIGNED.get((n, rate)) or ref_dv.synthetic_address_table(n, rate)
    fp = tables.table_fingerprint(mine)
    assert fp == ref_tables.table_fingerprint(theirs)
    name = f"dvbs2_{n}_{rate}_addresses"
    tables.register(name, fp, allow_update=True)
    assert tables.verify(name, theirs)


@pytest.mark.parametrize("n,rate", [(16200, "1/2"), (64800, "1/2")])
def test_interop_carries_dvbs2_codes(n, rate):
    theirs = ref_dv.dvbs2(n, rate)
    carried, mine = interop.code_from_reference(theirs), dv.dvbs2(n, rate)
    for a, b in zip(carried.blocks, mine.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(carried.layer_ptr, mine.layer_ptr)
    for a, b in zip(carried.block_row_masks, mine.block_row_masks):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert sum(m is not None for m in mine.block_row_masks) == 1
    assert carried.num_edges == mine.num_edges == theirs.num_edges


# -- the plain version against the TPU kernel --------------------------------------

def _random_qc(z, m_b=4, n_b=9, seed=7, extra=False, masked=False):
    """tests/test_zlane.py::_random_qc: a small QC code with a staircase
    parity part, optionally with a multi-edge cell and a masked row (the
    DVB-S2 wrap-block shape)."""
    rng = np.random.default_rng(seed)
    k_b = n_b - m_b
    base = np.full((m_b, n_b), -1, dtype=np.int32)
    for i in range(m_b):
        for j in rng.choice(k_b, size=3, replace=False):
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


def _all_zero_llr(n, batch, seed, lo=1.0, hi=8.0):
    """Consistent Gaussian LLRs of the all-zero codeword (mean m, variance
    2m), m spread over the batch from ``lo`` to ``hi``."""
    rng = np.random.default_rng(seed)
    m = np.linspace(lo, hi, batch, dtype=np.float32)[:, None]
    return (m + np.sqrt(2 * m) * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.mark.parametrize("structure,weights", [
    ("multi-edge+masked", "alpha0.75"),
    ("multi-edge+masked", "per-layer"),
    ("masked", "per-layer"),
])
def test_plain_matches_zlane_kernel_on_dvbs2_structures(structure, weights):
    rcode = _random_qc(150, extra="multi-edge" in structure,
                       masked="masked" in structure)
    alpha = 0.75 if weights == "alpha0.75" else (0.7, 0.8, 0.75, 0.85)
    kw = dict(normalization=alpha, max_iters=10)
    llr = _all_zero_llr(rcode.n, 8, seed=11)
    want = decode_qc_zlane(rcode, ref.DecoderConfig(schedule="layered", **kw),
                           jnp.asarray(llr), True)
    code = interop.code_from_reference(rcode)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_equal(got, want)
    conv = got.converged.numpy()
    assert 0 < conv.sum() < len(conv)  # both latched and straggling frames


def test_lazy_plain_meets_the_reference_lazy_contract():
    """At a benign point: the same converged frames and bits as the exact
    mode, converged => zero syndrome, and detection never earlier than
    exact.  The TPU kernel gates the exact pass per 8-codeword tile, so
    its lazy counts lie between the exact ones and the port's."""
    rcode = _random_qc(150, extra=True, masked=True)
    code = interop.code_from_reference(rcode)
    llr = _all_zero_llr(rcode.n, 8, seed=12, lo=5.0, hi=8.0)
    cfg = dict(normalization=0.75, max_iters=20)
    theirs = decode_qc_zlane(
        rcode, ref.DecoderConfig(schedule="layered", syndrome_mode="lazy", **cfg),
        jnp.asarray(llr), True)
    exact = cuda_long.decode_qc_long_plain(code, DecoderConfig(**cfg),
                                           torch.from_numpy(llr))
    lazy = cuda_long.decode_qc_long(
        code, DecoderConfig(syndrome_mode="lazy", **cfg), torch.from_numpy(llr))
    conv = lazy.converged.numpy()
    assert conv.all()
    np.testing.assert_array_equal(np.asarray(theirs.converged), conv)
    np.testing.assert_array_equal(exact.converged.numpy(), conv)
    np.testing.assert_array_equal(lazy.bits.numpy(), exact.bits.numpy())
    np.testing.assert_array_equal(np.asarray(theirs.bits), exact.bits.numpy())
    assert not code.syndrome(lazy.bits.numpy()).any()
    e, t, p = exact.iterations.numpy(), np.asarray(theirs.iterations), lazy.iterations.numpy()
    assert (e <= t).all() and (t <= p).all()
    assert (p > e).any()  # the on-the-fly check does lag


def test_lazy_gate_is_per_codeword():
    """A frame whose exact syndrome passes on a sweep where its on-the-fly
    check fails waits for a later sweep, even where another frame of the
    batch latches on that sweep (the TPU kernel's tile gating would latch
    both), and decodes the same alone as in the batch."""
    code = dv.dvbs2(16200, "1/2")
    _, llr = _llr(code, 16, 1.5, seed=1)
    x = torch.from_numpy(llr)
    cfg = DecoderConfig(normalization=0.85, max_iters=30)
    exact = cuda_long.decode_qc_long_plain(code, cfg, x)
    lazy_cfg = DecoderConfig(normalization=0.85, max_iters=30, syndrome_mode="lazy")
    lazy = cuda_long.decode_qc_long(code, lazy_cfg, x)
    e, p = exact.iterations.numpy(), lazy.iterations.numpy()
    assert exact.converged.all() and lazy.converged.all()
    # frame b: exact syndrome zero at sweep t, pre-check failed there;
    # frame a: latched (pre-check and exact syndrome passed) at sweep t
    pairs = [(a, b) for b in range(16) for a in range(16)
             if p[b] > e[b] and p[a] == e[b]]
    assert pairs
    a, b = pairs[0]
    alone = cuda_long.decode_qc_long(code, lazy_cfg, x[[b]])
    assert int(alone.iterations[0]) == p[b] > p[a]
    np.testing.assert_array_equal(alone.bits.numpy()[0], lazy.bits.numpy()[b])


# -- the slice as a whole ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "lazy"])
def test_decoder_matches_reference_on_dvbs2_16200(mode):
    """Both Decoders run the plain layered path on the CPU, which checks the
    exact syndrome whatever the mode says."""
    code, rcode = dv.dvbs2(16200, "1/2"), ref_dv.dvbs2(16200, "1/2")
    u, llr = _llr(code, 8, 1.0, seed=4)
    kw = dict(normalization=0.85, max_iters=20, syndrome_mode=mode)
    dec = Decoder(code, DecoderConfig(**kw), device="cpu")
    assert dec.implementation == "torch"
    got = dec(llr)
    want = ref.Decoder(rcode, ref.DecoderConfig(**kw))(llr)
    _assert_equal(got, want)
    conv = got.converged.numpy()
    assert conv.all()
    np.testing.assert_array_equal(dec.info_bits(got).numpy(), u)


@pytest.mark.parametrize("early_exit", [True, False])
def test_soft_output_matches_reference_on_dvbs2_16200(early_exit):
    """Kernel C's plain version with soft output on the multi-edge, masked
    DVB-S2 code: bits, iterations and the posteriors of every frame equal
    the jnp path's, at a point where some frames run out of iterations."""
    code, rcode = dv.dvbs2(16200, "1/2"), ref_dv.dvbs2(16200, "1/2")
    _, llr = _llr(code, 8, 1.2, seed=5)
    kw = dict(normalization=0.85, max_iters=10, soft_output=True, early_exit=early_exit)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw), torch.from_numpy(llr))
    want = ref.Decoder(rcode, ref.DecoderConfig(implementation="jnp", **kw))(llr)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got.posteriors.numpy(), np.asarray(want.posteriors))
    conv = got.converged.numpy()
    assert 0 < conv.sum() < len(conv)


def test_sum_product_soft_agrees_with_reference_on_dvbs2_16200():
    """Sum-product with soft output, at a converging point: equal bits and
    converged flags, iterations within 1 (torch's exp/log1p are not
    XLA's), and posteriors whose signs are the bits."""
    code, rcode = dv.dvbs2(16200, "1/2"), ref_dv.dvbs2(16200, "1/2")
    _, llr = _llr(code, 8, 1.2, seed=6)
    kw = dict(algorithm="sum-product", max_iters=20, soft_output=True)
    got = cuda_long.decode_qc_long(code, DecoderConfig(**kw), torch.from_numpy(llr))
    want = ref.Decoder(rcode, ref.DecoderConfig(implementation="jnp", **kw))(llr)
    for f in ("bits", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1
    assert got.converged.all()
    np.testing.assert_array_equal(got.posteriors.numpy() <= 0, got.bits.numpy() == 1)


def test_long_kernel_serves_dvbs2(monkeypatch):
    """The long-code kernel's gate takes DVB-S2 (multi-edge cells, the
    masked wrap row, rows of 35 circulants, the lazy syndrome); on a CUDA
    device auto dispatch resolves to it (its fit query, which needs the
    card, is stubbed here: shared memory for 16200, global for 64800)."""
    from myldpccppapi_torch import decoder
    from myldpccppapi_torch.ops import cuda_bp

    short, wide = dv.dvbs2(16200, "1/2"), dv.dvbs2(16200, "8/9")
    assert wide.max_row_degree == 35
    for code in (short, wide):
        for mode in ("exact", "lazy"):
            cfg = DecoderConfig(syndrome_mode=mode)
            assert cuda_long.supported(code, cfg)
            assert not cuda_bp.supported(code, cfg)
    monkeypatch.setattr(cuda_long, "placement",
                        lambda code, index, itemsize=4: cuda_long.SHARED
                        if code.n <= 16200 else cuda_long.GLOBAL)
    cuda = torch.device("cuda", 0)
    for code in (short, wide, dv.dvbs2(64800, "1/2")):
        assert decoder._implementation(code, DecoderConfig(syndrome_mode="lazy"),
                                       cuda) == "cuda_long"


def test_kernel_tables_layout():
    """The host tables the long-code kernel reads (built here on the CPU):
    the wrap block's shift word carries mask slot 1, its live-row words
    clear row 0 only, and the layer flags mark the multi-edge layers and
    the masked one."""
    code = dv.dvbs2(16200, "1/2")
    tables = cuda_long._device_tables(code, 0.85, 0.0, torch.device("cpu"))
    col, shift, ptr, flags, live, alpha, beta = (t.numpy() for t in tables)
    _, bc, sh = code.blocks
    masked = [e for e, m in enumerate(code.block_row_masks) if m is not None]
    assert len(masked) == 1 and (flags & cuda_launch.MULTI_EDGE).any()
    np.testing.assert_array_equal(col, bc)
    np.testing.assert_array_equal(shift & 0xFFFF, sh)
    np.testing.assert_array_equal(shift >> 16, np.isin(np.arange(len(sh)), masked))
    bits = np.unpackbits(live.view(np.uint8), bitorder="little")[:code.z]
    np.testing.assert_array_equal(bits.astype(bool), code.block_row_masks[masked[0]])
    wrap_layer = int(code.blocks[0][masked[0]])
    cells = [bc[ptr[i]:ptr[i + 1]] for i in range(code.m_b)]
    np.testing.assert_array_equal(flags & 1, [len(set(c)) < len(c) for c in cells])
    np.testing.assert_array_equal(flags >> 1, np.arange(code.m_b) == wrap_layer)
    np.testing.assert_array_equal(ptr, code.layer_ptr)
    assert (alpha == np.float32(0.85)).all() and (beta == 0).all()


def test_cli_waterfall_dvbs2_and_resume(tmp_path, capsys):
    ck = tmp_path / "ck.json"
    argv = ["waterfall", "--family", "dvbs2", "--n", "16200", "--rate", "1/2",
            "--snr=0.5,1.5", "--batch", "8", "--target-errors", "4",
            "--max-frames", "8", "--max-iters", "6", "--normalization", "0.85",
            "--checkpoint", str(ck), "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["snr=+0.50", "snr=+1.50"]
    assert cli.main(argv) == 0  # resumed: nothing left to simulate
    assert capsys.readouterr().out.strip().splitlines() == lines
    # the outer BCH is another campaign (its fingerprint), which starts
    # afresh and prints the same points
    fp = json.loads(ck.read_text())["fingerprint"]
    assert cli.main([*argv, "--bch"]) == 0
    bch_lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in bch_lines] == ["snr=+0.50", "snr=+1.50"]
    assert json.loads(ck.read_text())["fingerprint"] != fp
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main([*argv, "--bch", "--crc", "16"])


def test_sim_step_takes_the_dvbs2_encoder():
    code = dv.dvbs2(16200, "1/2")
    gen = torch.Generator().manual_seed(3)
    stats = sim_step(code, DecoderConfig(normalization=0.85, max_iters=20), gen,
                     2.5, 4, encode_fn=dv.ira_encode_fn(code),
                     decode_fn=make_decode_fn(code, DecoderConfig(
                         normalization=0.85, max_iters=20), device="cpu"))
    got = {k: int(v) for k, v in stats._asdict().items()}
    assert got["frames"] == 4 and got["info_bits"] == 4 * code.k
    assert got["frame_errors"] == got["unconverged"] == 0
    assert 0 < got["iterations"] <= 4 * 20


# -- entry points default to the card -----------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["Decoder", "Coder", "Encoder",
                                   "matmul_encode_fn", "make_decode_fn"])
def test_entry_points_default_to_the_card(no_cuda, entry):
    """With no device given each entry point asks for the card and raises
    where there is no CUDA; ``device="cpu"`` is the way onto the CPU."""
    from myldpccppapi_torch import wimax

    code = wimax(576, "1/2")
    make = {
        "Decoder": lambda **kw: Decoder(code, **kw),
        "Coder": lambda **kw: Coder(288, 576, "1/2", **kw),
        "Encoder": lambda **kw: Encoder(code, **kw),
        "matmul_encode_fn": lambda **kw: matmul_encode_fn(code, **kw),
        "make_decode_fn": lambda **kw: make_decode_fn(code, DecoderConfig(), **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert make(device="cpu") is not None


def test_decoder_without_a_device_raises_here():
    """On this CUDA-less host, Decoder(code) asks for the card and raises."""
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(dv.dvbs2(16200, "1/2"))


@pytest.mark.parametrize("argv", [
    ["test", "432", "8", "5.0", "TDMP"],
    ["waterfall", "--family", "dvbs2", "--n", "16200"],
])
def test_cli_device_defaults_to_cuda(no_cuda, argv):
    """No availability fallback: the default stays "cuda" on a host without
    CUDA, and running there raises."""
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
