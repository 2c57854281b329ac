"""The DVB-S2 standard-domain oracle (``codes/dvbs2.py::DVBS2Code``,
``dvbs2_oracle``) against the JAX package on the CPU.

* The oracle's structure (n, k, q, addresses, information edges, the full
  edge list, the mod-q edge tables), its NumPy encoder and syndrome and its
  torch encoder equal the reference's at 16200 r1/2.
* Its H equals the port's ``dvbs2_ira_qc`` under the row-residue and
  ``std_interleave`` permutations (multi-edge cells and the masked wrap
  included): the port's own copy of the reference's
  ``test_ira_qc_matches_standard_domain_h``.
* ``interop.code_from_reference`` carries a reference ``DVBS2Code``
  across, and the port's ``Decoder`` (auto: the edge list) on it equals
  the reference's ``Decoder``, layered and flooding.
The card runs the oracle at 64800 in chip_smoke.py (phases 3k and 4n)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref

from myldpccppapi_torch import Decoder, DecoderConfig, interop
from myldpccppapi_torch.codes import DVBS2Code, dvbs2_oracle

torch.set_num_threads(1)

ref_dv = importlib.import_module("myldpccppapi_tpu.codes.dvbs2")
dv = importlib.import_module("myldpccppapi_torch.codes.dvbs2")


@pytest.fixture(scope="module")
def codes():
    return dvbs2_oracle(16200, "1/2"), ref_dv.dvbs2_oracle(16200, "1/2")


def test_structure_matches_reference(codes):
    mine, theirs = codes
    assert isinstance(mine, DVBS2Code)
    assert (mine.name, mine.n, mine.k, mine.m, mine.q, mine.k_info) == (
        theirs.name, theirs.n, theirs.k, theirs.m, theirs.q, theirs.k_info)
    assert mine.n == 16200 and mine.k == 7200 and mine.q == 25
    assert mine.addresses == theirs.addresses
    assert mine.rate == theirs.rate and mine.describe() == theirs.describe()
    np.testing.assert_array_equal(mine.info_positions, theirs.info_positions)
    for a, b in zip(mine.info_edges, theirs.info_edges):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.h_coo(), theirs.h_coo()):
        np.testing.assert_array_equal(a, b)
    assert mine.edge_index.num_layers == theirs.edge_index.num_layers == mine.q
    np.testing.assert_array_equal(mine.edge_index.row_layer, theirs.edge_index.row_layer)


@pytest.mark.parametrize("n,rate", [(16200, "1/2"), (16200, "8/9"), (64800, "1/2")])
def test_oracle_tables_match_reference(n, rate):
    mine, theirs = dvbs2_oracle(n, rate), ref_dv.dvbs2_oracle(n, rate)
    assert mine.addresses == theirs.addresses and mine.k == theirs.k


def test_encoders_match_reference(codes):
    mine, theirs = codes
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, size=(5, mine.k), dtype=np.uint8)
    c = mine.encode_numpy(u)
    np.testing.assert_array_equal(c, theirs.encode_numpy(u))
    assert mine.syndrome(c).sum() == 0
    np.testing.assert_array_equal(mine.syndrome(c ^ 1), theirs.syndrome(c ^ 1))
    assert (c[:, : mine.k] == u).all()  # systematic
    got = mine.encode_fn()(torch.from_numpy(u))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), c)
    want = np.asarray(jax.jit(theirs.encode_fn())(jnp.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), want)
    # other integer input types give the same codeword
    np.testing.assert_array_equal(
        mine.encode_fn()(torch.from_numpy(u.astype(np.int64))).numpy(), c)


def _std_h_dense(code):
    """The oracle's H as a dense [m, n] bool array, from its edge list."""
    rows, cols = code.h_coo()
    h = np.zeros((code.m, code.n), dtype=bool)
    h[rows, cols] = True
    return h


def test_oracle_h_is_the_qc_code_under_the_permutations():
    """tests/test_dvbs2.py::test_ira_qc_matches_standard_domain_h on the
    port: std row i is internal row (i % q) * z + (i // q), std column p is
    internal column std_interleave(n, k)[p]."""
    n, rate = 16200, "8/9"  # k=14400, m=1800, q=5: small enough for dense
    oracle = dvbs2_oracle(n, rate)
    code = dv.dvbs2_ira_qc(n, rate)
    k, m, q, z = code.k, code.m, code.m_b, code.z
    assert (oracle.k, oracle.m, oracle.q) == (k, m, q)
    h_std = _std_h_dense(oracle)
    i = np.arange(m)
    row_perm = (i % q) * z + i // q
    col_perm = dv.std_interleave(n, k)
    h_perm = np.zeros_like(h_std)
    h_perm[row_perm[:, None], col_perm[None, :]] = h_std
    assert code.extra_blocks or code.masked_rows
    assert (code.h_dense() == h_perm).all()
    # the same codewords: the QC encode, read in the standard order, is an
    # oracle codeword with the same information bits
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, size=(3, k), dtype=np.uint8)
    std = dv.ira_encode_numpy(code, u)[:, col_perm]
    np.testing.assert_array_equal(std, oracle.encode_numpy(u))


def test_code_from_reference_carries_the_oracle(codes):
    mine, theirs = codes
    carried = interop.code_from_reference(theirs)
    assert isinstance(carried, DVBS2Code)
    assert (carried.name, carried.n, carried.k, carried.addresses) == (
        mine.name, mine.n, mine.k, mine.addresses)
    for a, b in zip(carried.h_coo(), theirs.h_coo()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_decoder_on_the_carried_oracle_matches_reference(codes, schedule):
    """The port's ``Decoder`` (auto resolves to the edge list on the CPU
    too) on the carried code against the reference's, 1.2 dB, alpha 0.8:
    every field equal, the posteriors included."""
    mine, theirs = codes
    carried = interop.code_from_reference(theirs)
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2, size=(8, mine.k), dtype=np.uint8)
    c = mine.encode_numpy(u)
    sigma = np.float32(10 ** (-1.2 / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    llr = (y * np.float32(2 / sigma**2)).astype(np.float32)
    cfg = dict(schedule=schedule, normalization=0.8, max_iters=12, soft_output=True)
    dec = Decoder(carried, DecoderConfig(**cfg), device="cpu")
    assert dec.implementation == "edgelist"
    got = dec(llr)
    ref_dec = ref.Decoder(theirs, ref.DecoderConfig(**cfg))
    assert ref_dec.implementation == "edgelist"
    want = ref_dec(jnp.asarray(llr))
    for f in ("bits", "converged", "iterations", "total_iters", "posteriors"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(dec.info_bits(got).numpy(),
                                  np.asarray(ref_dec.info_bits(want)))
