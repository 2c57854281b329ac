"""The port's layered min-sum decode (the CUDA kernel's plain version) is
bit-exact with the JAX package's jnp path on the same NumPy LLRs.  The
reference's own tests pin that jnp path to the TPU kernel
(tests/test_pallas.py); chip_smoke.py pins the CUDA kernel to this path on
the card."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu.ops.bp import decode_qc as ref_decode_qc

from myldpccppapi_torch import interop
from myldpccppapi_torch.codes import encode_numpy, ru_precompute, wimax
from myldpccppapi_torch.ops import cuda_bp, cuda_launch
from myldpccppapi_torch.ops.bp import decode_layered
from myldpccppapi_torch.utils.config import DecoderConfig

torch.set_num_threads(1)

CODE = wimax(576, "3/4B")
REF_CODE = ref.wimax(576, "3/4B")
BATCH = 32
PER_LAYER = (0.7, 0.75, 0.8, 0.85, 0.8, 0.72)
WEIGHTS = {
    "alpha0.75": dict(normalization=0.75),
    "alpha1.0": dict(normalization=1.0),
    "beta0.5": dict(offset=0.5),
    "per-layer-alpha": dict(normalization=PER_LAYER),
}
FIELDS = ("bits", "converged", "iterations", "total_iters")
#: noise seeds: at 5 dB every frame of the batch converges, so early exit
#: ends the loop; at 2 dB most frames reach max_iters
SEEDS = {5.0: 10, 2.0: 2}
_REF_FNS = {}


def _llr(snr_db: float, seed: int = 0, code=CODE, batch=BATCH) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def _reference(kw, llr):
    """The JAX jnp decode, one compile per configuration."""
    key = tuple(sorted(kw.items()))
    if key not in _REF_FNS:
        cfg = ref.DecoderConfig(implementation="jnp", **kw)
        _REF_FNS[key] = jax.jit(partial(ref_decode_qc, REF_CODE, cfg))
    return _REF_FNS[key](jnp.asarray(llr))


def _assert_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("snr_db", [5.0, 2.0])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_decode_layered_matches_jnp(weights, early_exit, snr_db):
    kw = dict(WEIGHTS[weights], early_exit=early_exit)
    llr = _llr(snr_db, seed=SEEDS[snr_db])
    got = decode_layered(CODE, DecoderConfig(**kw), torch.from_numpy(llr))
    _assert_equal(got, _reference(kw, llr))
    conv = got.converged.numpy()
    if snr_db == 2.0:
        # below threshold: frames run into max_iters, where any difference
        # in the f32 operation order would show
        assert (~conv).sum() > BATCH // 2 and int(got.total_iters) == 40
    elif early_exit:
        assert conv.all() and int(got.total_iters) < 40


def test_decode_qc_and_cpu_wrapper_are_the_torch_path():
    cfg = DecoderConfig(normalization=0.75)
    llr = torch.from_numpy(_llr(4.0, seed=9))
    want = decode_layered(CODE, cfg, llr)
    before = cuda_bp.decode_qc_cuda.launches
    for fn in (cuda_bp.decode_qc_cuda, cuda_bp.decode_qc_cuda_plain):
        got = fn(CODE, cfg, llr)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert cuda_bp.decode_qc_cuda.launches == before  # no kernel on the CPU


def test_decode_leaves_the_input_untouched():
    llr = torch.from_numpy(_llr(3.0, seed=1, batch=1))
    copy = llr.clone()
    decode_layered(CODE, DecoderConfig(), llr)
    assert torch.equal(llr, copy)


def test_ragged_batch_and_other_rate_match_jnp():
    code, theirs = wimax(576, "1/2"), ref.wimax(576, "1/2")
    llr = _llr(1.5, seed=3, code=code, batch=7)
    cfg = dict(normalization=0.8, offset=0.1, max_iters=12)
    got = decode_layered(code, DecoderConfig(**cfg), torch.from_numpy(llr))
    want = ref_decode_qc(theirs, ref.DecoderConfig(**cfg), jnp.asarray(llr))
    _assert_equal(got, want)


def test_masked_and_multi_edge_codes_match_jnp():
    """Partial circulants and two circulants in one block (the DVB-S2
    structures) run on the torch path with the reference's masking and
    delta write-back; the short-code CUDA kernel refuses the partial
    circulants (test_kernel_gate)."""
    base = np.asarray(ref.wimax(576, "1/2").base)
    j0 = int(np.flatnonzero(base[0] >= 0)[0])  # first circulant of layer 0
    j1 = int(np.flatnonzero(base[1] >= 0)[0])  # first circulant of layer 1
    extra = ((0, j0, (int(base[0, j0]) + 5) % 24),)
    masked = (((1, j1, int(base[1, j1])), (0, 3)),)
    kw = dict(base=base, z=24, extra_blocks=extra, masked_rows=masked)
    theirs = ref.QCCode(name="odd", **kw)
    mine = interop.code_from_reference(theirs)
    llr = (1.5 + 2.0 * np.random.default_rng(8).standard_normal(
        (9, mine.n))).astype(np.float32)
    cfg = dict(normalization=0.75, max_iters=15)
    got = decode_layered(mine, DecoderConfig(**cfg), torch.from_numpy(llr))
    want = ref_decode_qc(theirs, ref.DecoderConfig(**cfg), jnp.asarray(llr))
    _assert_equal(got, want)
    assert not cuda_bp.supported(mine)


def test_kernel_gate():
    """supported(): the TPU kernels' split at 120 circulants; past it only
    kernel B's route (layered min-sum, z < 64, where kernel C does not
    serve).  Multi-edge cells are served (kernel A's layered sweep is
    multi-edge safe, pallas_bp.py:301-310, and the CUDA kernel writes a
    cell's deltas through a table); partial circulants are refused, as
    pallas_bp.supported refuses them."""
    assert all(cuda_bp.supported(wimax(n, r))
               for n, r in [(576, "1/2"), (576, "3/4B"), (2304, "5/6")])
    dense = type(CODE)(name="dense", base=np.zeros((12, 24), np.int32), z=24)
    assert dense.num_blocks > 120 and cuda_bp.supported(dense)
    assert not cuda_bp.supported(dense, DecoderConfig(schedule="flooding"))
    wide = type(CODE)(name="wide", base=np.zeros((12, 24), np.int32), z=64)
    assert not cuda_bp.supported(wide)
    multi = type(CODE)(name="multi", base=CODE.base, z=CODE.z,
                       extra_blocks=((0, 0, 5),))
    assert cuda_bp.supported(multi)
    masked = type(CODE)(name="masked", base=CODE.base, z=CODE.z,
                        masked_rows=(((0, 1, int(CODE.base[0, 1])), (0,)),))
    assert not cuda_bp.supported(masked)
    assert cuda_bp.supported(CODE, DecoderConfig(normalization=PER_LAYER))


def _multi_edge_z8():
    """A small multi-edge code (z = 8): a 3 x 6 base of circulants with one
    extra circulant in each layer, in both packages."""
    base = np.array([[0, 1, 2, 3, 4, 5], [0, 2, 4, 6, 1, 3], [0, 3, 6, 1, 4, 7]],
                    dtype=np.int32)
    extra = ((0, 0, 4), (1, 3, 2), (2, 5, 0))
    theirs = ref.QCCode(name="multi_z8", base=base, z=8, extra_blocks=extra)
    return interop.code_from_reference(theirs), theirs


def test_cell_table_marks_each_cell_in_block_order():
    """Kernel A's cell table (ops/cuda_bp.py::cell_table): a block that
    shares its column with another of its layer gets the next row of the
    layer's delta table, in block order; a lone circulant gets -1; then
    each layer's count of rows.  A code without cells has none."""
    mine, _ = _multi_edge_z8()
    _, bc, _ = mine.blocks
    table = cuda_bp.cell_table(mine)
    slot, rows = table[:mine.num_blocks], table[mine.num_blocks:]
    assert table.dtype == np.int32 and rows.tolist() == [2, 2, 2]
    for i in range(mine.m_b):
        lo, hi = mine.layer_ptr[i], mine.layer_ptr[i + 1]
        cols = bc[lo:hi].tolist()
        cell = [cols.count(j) > 1 for j in cols]
        assert slot[lo:hi][cell].tolist() == list(range(sum(cell)))
        assert (slot[lo:hi][~np.array(cell)] == -1).all()
    assert cuda_launch.group_slots(mine) == 2
    plain = cuda_bp.cell_table(CODE)
    assert (plain[:CODE.num_blocks] == -1).all() and not plain[CODE.num_blocks:].any()
    assert cuda_launch.group_slots(CODE) == 0


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_multi_edge_plain_matches_kernel_a_interpret(schedule):
    """The CUDA kernel's plain version on multi-edge cells against the TPU
    kernel A itself (Pallas interpret mode): the layered sweep reads every
    q of a layer from the old posterior and adds a cell's deltas in block
    order, the flooding rebuild walks a column's circulants in order."""
    from myldpccppapi_tpu.ops.pallas_bp import decode_qc_pallas

    mine, theirs = _multi_edge_z8()
    assert cuda_launch.group_slots(mine) == 2  # one two-circulant cell a layer
    llr = (1.0 + 2.0 * np.random.default_rng(12).standard_normal(
        (8, mine.n))).astype(np.float32)
    cfg = dict(schedule=schedule, normalization=0.75, max_iters=12)
    got = cuda_bp.decode_qc_cuda_plain(mine, DecoderConfig(**cfg),
                                       torch.from_numpy(llr))
    want = decode_qc_pallas(theirs, ref.DecoderConfig(**cfg), jnp.asarray(llr), True)
    for f in ("bits", "iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert cuda_bp.supported(mine, DecoderConfig(**cfg))
