"""The port's design tools against the JAX package: PEXIT (J, J^-1,
pexit_run, thresholds), the PEXIT-guided design searches at a few steps,
the profiling helpers, and the CLI's ``threshold`` and ``design`` lines.

All of it is host-side NumPy in both packages, the same operations in the
same order, so every number is held equal (no tolerance)."""
import json

import numpy as np
import pytest
import torch

import myldpccppapi_tpu as ref
from myldpccppapi_tpu import cli as ref_cli
from myldpccppapi_tpu.codes import design as ref_design
from myldpccppapi_tpu.codes import pexit as ref_pexit
from myldpccppapi_tpu.utils import profiling as ref_profiling

from myldpccppapi_torch import bench, codes
from myldpccppapi_torch.cli import main
from myldpccppapi_torch.codes import design, pexit
from myldpccppapi_torch.utils import (PhaseTimer, emit_metrics, iterations_histogram,
                                      trace)

torch.set_num_threads(1)


def test_j_and_j_inv_equal_reference():
    s = np.linspace(0.0, 12.0, 997)
    np.testing.assert_array_equal(pexit.J(s), ref_pexit.J(s))
    i = np.linspace(0.0, 1.0, 997)
    np.testing.assert_array_equal(pexit.J_inv(i), ref_pexit.J_inv(i))
    assert codes.threshold_ebn0 is pexit.threshold_ebn0
    assert {"pexit_run", "protograph", "threshold_ebn0", "threshold_sigma"} <= set(codes.__all__)


PROTOS = {
    "regular36": lambda pkg: np.ones((3, 6), dtype=int),
    "multiedge": lambda pkg: np.array([[3, 3]]),
    "wimax576_r12": lambda pkg: pkg.wimax(576, "1/2"),
    "wimax576_r56": lambda pkg: pkg.wimax(576, "5/6"),
    "nr_bg2_z64": lambda pkg: pkg.nr_code(64, 2),
    "rs_ldpc_4_4_8": lambda pkg: pkg.rs_ldpc(4, 4, 8),
}


@pytest.mark.parametrize("name", list(PROTOS))
def test_thresholds_equal_reference(name):
    mine, theirs = PROTOS[name](codes), PROTOS[name](ref.codes)
    assert pexit.threshold_ebn0(mine) == ref_pexit.threshold_ebn0(theirs)
    assert pexit.threshold_sigma(mine) == ref_pexit.threshold_sigma(theirs)
    if not isinstance(mine, np.ndarray):
        np.testing.assert_array_equal(pexit.protograph(mine), ref_pexit.protograph(theirs))


@pytest.mark.parametrize("ebn0", [-1.0, 1.2, 3.0])
def test_pexit_run_fields_equal_reference(ebn0):
    b = pexit.protograph(codes.wimax(576, "1/2"))
    s = np.full(b.shape[1], 8.0 * 0.5 * 10 ** (ebn0 / 10))
    got, want = pexit.pexit_run(b, s), ref_pexit.pexit_run(b, s)
    assert (got.converged, got.iterations) == (want.converged, want.iterations)
    np.testing.assert_array_equal(got.i_app, want.i_app)
    np.testing.assert_array_equal(got.ber, want.ber)


def test_optimize_nr_support_equals_reference():
    b, thr = design.optimize_nr_support(bg=2, steps=6, seed=7)
    b_r, thr_r = ref_design.optimize_nr_support(bg=2, steps=6, seed=7)
    np.testing.assert_array_equal(b, b_r)
    assert thr == thr_r
    np.testing.assert_array_equal(design.nr_support_default(1),
                                  ref_design.nr_support_default(1))


def test_optimize_dvbs2_profile_equals_reference():
    bi, thr = design.optimize_dvbs2_profile(16200, "1/2", steps=4, seed=5)
    bi_r, thr_r = ref_design.optimize_dvbs2_profile(16200, "1/2", steps=4, seed=5)
    np.testing.assert_array_equal(bi, bi_r)
    assert thr == thr_r
    assert design.realize_dvbs2_addresses(bi, 16200, "1/2", draws=2) == \
        ref_design.realize_dvbs2_addresses(bi_r, 16200, "1/2", draws=2)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_helpers_equal_reference(tmp_path):
    it = np.array([1, 2, 2, 40, 3, 7, 40, 12])
    assert iterations_histogram(it, 40) == ref_profiling.iterations_histogram(it, 40)
    # an empty batch: nan statistics, compared as text
    assert str(iterations_histogram(np.array([], int), 5)) == \
        str(ref_profiling.iterations_histogram(np.array([], int), 5))
    assert emit_metrics(str(tmp_path / "a.json"), x=1, y=np.float32(2.5)) == \
        ref_profiling.emit_metrics(str(tmp_path / "b.json"), x=1, y=np.float32(2.5))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    t = PhaseTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert set(rep["a"]) == {"total_s", "calls", "mean_s"}
    t.reset()
    assert t.report() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    from myldpccppapi_torch import Decoder, wimax

    dec = Decoder(wimax(576, "1/2"), device="cpu", max_iters=3)
    with trace(None):  # a no-op
        dec(torch.ones((2, 576)))
    with trace(str(tmp_path / "tr")):
        dec(torch.ones((2, 576)))
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["threshold"],
    ["threshold", "--family", "rs_ldpc", "--n", "2048"],
    ["design", "--family", "nr", "--bg", "2", "--steps", "3"],
], ids=["threshold wimax", "threshold rs_ldpc", "design nr"])
def test_cli_lines_equal_reference(argv, capsys, tmp_path):
    out_args = []
    if argv[0] == "design":
        out_args = ["--out", str(tmp_path / ("mine.npy" if "nr" in argv else "mine.txt"))]
    assert main(argv + out_args) == 0
    mine = capsys.readouterr().out
    if out_args:
        out_args = ["--out", str(tmp_path / ("ref.npy" if "nr" in argv else "ref.txt"))]
    ref_cli.build_parser().parse_args(argv + out_args).fn(
        ref_cli.build_parser().parse_args(argv + out_args))
    theirs = capsys.readouterr().out
    assert mine.replace("mine.", "ref.") == theirs
    if out_args:
        a, b = sorted(tmp_path.iterdir())[0], sorted(tmp_path.iterdir())[1]
        assert a.read_bytes() == b.read_bytes()


def test_cli_bench_refused_naming_its_item(monkeypatch, capsys):
    """``bench`` runs now; what it refuses is a failed gate: below its
    operating point (2 dB) the convergence gate raises and no record is
    printed."""
    monkeypatch.setattr(bench, "BATCH", 64)
    monkeypatch.setattr(bench, "SNR_DB", 2.0)
    with pytest.raises(RuntimeError, match="bench gate: convergence"):
        main(["bench", "--device", "cpu"])
    assert capsys.readouterr().out == ""
