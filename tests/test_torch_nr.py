"""The port's 5G NR family (codes/nr.py, codes/nr_designed.py,
codes/tables.py) against the JAX package: the same base graphs, lifted
codes and table fingerprints; the same encode and rate matching on the same
NumPy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myldpccppapi_tpu.codes import nr as ref_nr
from myldpccppapi_tpu.codes import tables as ref_tables

from myldpccppapi_torch.codes import nr, tables

torch.set_num_threads(1)

#: every lifting the slice decodes (384, 208), the smallest z the long
#: kernel serves (64), and a CPU-test size (16)
LIFTINGS = (384, 208, 64, 16)

CANONICAL = """
# row col V(iLS=0..7)
0 0 1 2 3 4 5 6 7 8
0 1 10 11 12 13 14 15 16 17
1 1 0 0 0 0 0 0 0 0
"""
CSV_WITH_HEADER = """
Row,Col,V0,V1,V2,V3,V4,V5,V6,V7
0,0,1,2,3,4,5,6,7,8
0,1,10,11,12,13,14,15,16,17   % inline comment
1,1,0,0,0,0,0,0,0,0
"""
PER_SET = "0 0 7\n0 1 16\n1 1 0\n"
DENSE = "7, 16\n-1, 0\n"


@pytest.mark.parametrize("support", [None, "legacy"])
@pytest.mark.parametrize("bg", [1, 2])
def test_base_graph_matches_reference(bg, support):
    mine = nr.nr_base_graph(bg, support=support)
    np.testing.assert_array_equal(mine, ref_nr.nr_base_graph(bg, support=support))
    assert tables.table_fingerprint(mine) == ref_tables.table_fingerprint(mine)


def test_shipped_fingerprints():
    """The reference's pinned fingerprints of the shipped default tables
    (tests/test_tables.py) hold for the port's copies."""
    assert tables.table_fingerprint(nr.nr_base_graph(1)) == (
        "033f5566f6e532c8528815db5e6c18707b3943f8f7ad895fb2229c8aec02c381")
    assert tables.table_fingerprint(nr.nr_base_graph(2)) == (
        "302d0ab50b8b93aea878d83d3ff37e4737557a9b3c454e818783f8e19b647104")


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("z", LIFTINGS)
def test_nr_code_matches_reference(z, bg):
    mine, theirs = nr.nr_code(z, bg), ref_nr.nr_code(z, bg)
    assert (mine.name, mine.z, mine.punctured_front) == (
        theirs.name, theirs.z, theirs.punctured_front)
    np.testing.assert_array_equal(mine.base, theirs.base)
    for a, b in zip(mine.blocks, theirs.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.layer_ptr, theirs.layer_ptr)
    assert tables.table_fingerprint(mine.base) == (
        ref_tables.table_fingerprint(theirs.base))


def test_lifting_sets():
    assert nr.NR_LIFTING_SETS == ref_nr.NR_LIFTING_SETS
    for zs in nr.NR_LIFTING_SETS:
        for z in zs:
            assert nr.lifting_set_index(z) == ref_nr.lifting_set_index(z)
    with pytest.raises(ValueError, match="lifting size"):
        nr.lifting_set_index(17)


@pytest.mark.parametrize("text", [CANONICAL, CSV_WITH_HEADER, PER_SET, DENSE])
def test_parse_bg_table_formats(text):
    mine = nr.parse_bg_table(text)
    np.testing.assert_array_equal(mine, ref_nr.parse_bg_table(text))
    assert tables.table_fingerprint(mine) == (
        ref_tables.table_fingerprint(ref_nr.parse_bg_table(text)))


def test_parse_bg_table_format_variants_fingerprint_alike():
    assert tables.table_fingerprint(nr.parse_bg_table(CANONICAL)) == (
        tables.table_fingerprint(nr.parse_bg_table(CSV_WITH_HEADER)))
    assert tables.table_fingerprint(nr.parse_bg_table(PER_SET)) == (
        tables.table_fingerprint(nr.parse_bg_table(DENSE)))


@pytest.mark.parametrize("text,match", [
    ("0 0 1 2 3 4 5 6 7 8\n0 0 1 2 3 4 5 6 7 9", "duplicate"),
    ("0 0 1 2 3 4 5 6 7 8\n0 1 1 2 3 4 5 x 7 8", "non-integer"),
    ("# nothing\n% here\n", "no table entries"),
    ("0 0 7\n0 1 16;  1 1 0\n", "inconsistent column counts"),
    ("0 0 7\n-1 1 3\n", "negative"),
    ("0 0 1 2 3 4 5 6 7\n0 1 1 2 3 4 5 6 7\n", "one off from the sparse"),
    ("0 0 -2\n", "< -1"),
    ("7 -2\n-1 0\n", "< -1"),
])
def test_parse_bg_table_refusals(text, match):
    for parse in (nr.parse_bg_table, ref_nr.parse_bg_table):
        with pytest.raises(ValueError, match=match):
            parse(text)


def test_table_drop_in_and_shape_checks():
    raw = nr.nr_base_graph(1)
    full = np.stack([np.where(raw >= 0, (raw + s) % 384, -1)
                     for s in range(8)], axis=-1)
    np.testing.assert_array_equal(nr.nr_code(24, 1, table=full).base,
                                  ref_nr.nr_code(24, 1, table=full).base)
    with pytest.raises(ValueError, match="single-set table must be"):
        nr.nr_code(16, 1, table=raw[:, :-1])
    with pytest.raises(ValueError, match=r"\[46, 68, 8\]"):
        nr.nr_code(16, 1, table=full[:, :-1])


def test_registry_verify_and_tamper_detection():
    t = nr.parse_bg_table(CANONICAL)
    name = "torch_test_bg_mini"
    tables.register(name, tables.table_fingerprint(t))
    assert tables.verify(name, t) is True
    tampered = t.copy()
    tampered[0, 0, 0] += 1
    with pytest.raises(ValueError, match="mismatch"):
        tables.verify(name, tampered)
    assert tables.verify("torch_test_unregistered", t) is False
    with pytest.raises(ValueError, match="no fingerprint registered"):
        tables.verify("torch_test_unregistered", t, strict=True)
    with pytest.raises(ValueError, match="already registered"):
        tables.register(name, "0" * 64)


def _info(code, batch, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(batch, code.k), dtype=np.uint8)


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("z", [64, 16])
def test_triangular_encode(z, bg):
    code, rcode = nr.nr_code(z, bg), ref_nr.nr_code(z, bg)
    u = _info(code, 6, seed=z + bg)
    want = ref_nr.triangular_encode_numpy(rcode, u)
    np.testing.assert_array_equal(nr.triangular_encode_numpy(code, u), want)
    got = nr.triangular_encode_fn(code)(torch.from_numpy(u))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(ref_nr.triangular_encode_fn(rcode)(jnp.asarray(u))), want)
    assert not code.syndrome(want).any()


@pytest.mark.parametrize("bg", [1, 2])
def test_rv_start(bg):
    code, rcode = nr.nr_code(16, bg), ref_nr.nr_code(16, bg)
    n_buf = code.n - code.punctured_front
    for rv in range(4):
        for n_cb in (None, n_buf // 2, 40 * 16):
            assert nr.rv_start(code, rv, n_cb) == ref_nr.rv_start(rcode, rv, n_cb)
    with pytest.raises(ValueError, match="rv must be"):
        nr.rv_start(code, 4)


#: transmitted lengths, as multiples of the circular buffer: shortened,
#: full, one wrap, and past two wraps
E_FRACTIONS = (0.4, 1.0, 1.7, 2.0, 3.3)


@pytest.mark.parametrize("frac", E_FRACTIONS)
@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_rate_match(rv, frac):
    code, rcode = nr.nr_code(16, 1), ref_nr.nr_code(16, 1)
    n_cb = code.n - code.punctured_front
    e = int(frac * n_cb)
    c = ref_nr.triangular_encode_numpy(rcode, _info(code, 3, seed=rv))
    np.testing.assert_array_equal(
        nr.rate_match_bits(code, torch.from_numpy(c), e, rv).numpy(),
        np.asarray(ref_nr.rate_match_bits(rcode, jnp.asarray(c), e, rv)))
    llr_e = np.random.default_rng(rv).standard_normal((3, e)).astype(np.float32)
    got = nr.rate_match_llr(code, torch.from_numpy(llr_e), e, rv).numpy()
    want = np.asarray(ref_nr.rate_match_llr(rcode, jnp.asarray(llr_e), e, rv))
    if e <= 2 * n_cb:
        # at most two contributions per position: their f32 sum is the same
        # in either order
        np.testing.assert_array_equal(got, want)
    else:
        # three or more: the port sums in transmission order, while XLA's
        # scatter-add fixes no order for repeated indices, so the sums may
        # differ by rounding (a few ulp of the |LLR| <~ 15 sums)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[:, : code.punctured_front] == 0).all()
    with pytest.raises(ValueError, match="disagrees"):
        nr.rate_match_llr(code, torch.from_numpy(llr_e), e + 1, rv)


def test_rate_match_limited_buffer():
    code, rcode = nr.nr_code(16, 2), ref_nr.nr_code(16, 2)
    n_cb = 30 * 16
    for e in (200, n_cb + 77):
        llr_e = np.random.default_rng(e).standard_normal((2, e)).astype(np.float32)
        np.testing.assert_array_equal(
            nr.rate_match_llr(code, torch.from_numpy(llr_e), e, 1, n_cb).numpy(),
            np.asarray(ref_nr.rate_match_llr(rcode, jnp.asarray(llr_e), e, 1, n_cb)))


def test_harq_combine():
    code, rcode = nr.nr_code(16, 1), ref_nr.nr_code(16, 1)
    rng = np.random.default_rng(3)
    txs = [(rng.standard_normal((2, e)).astype(np.float32), rv)
           for e, rv in ((700, 0), (500, 2), (900, 3))]
    got = nr.harq_combine(code, [(torch.from_numpy(x), rv) for x, rv in txs])
    want = ref_nr.harq_combine(rcode, [(jnp.asarray(x), rv) for x, rv in txs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    single = nr.harq_combine(code, [(torch.from_numpy(txs[0][0]), 0)])
    assert torch.equal(single, nr.rate_match_llr(code, torch.from_numpy(txs[0][0])))
    with pytest.raises(ValueError, match="at least one"):
        nr.harq_combine(code, [])
