"""The check catches a broken timed path: a run driven as usual, with no
look for a chip, on a cell cut to the CPU and a fault planted under the
``Decoder``, must come out not correct.  One test per fault a receive
cell can have."""
import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.cells import tiny
from portbench.tests.faults import altered, half_batch, unchanged


def _run(cell, **kw):
    return run_cell(cell, 2 ** 31 + 7, 1.0, False, time.time(), device="cpu", **kw)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_comes_out_not_correct(fault):
    line = _run(tiny(snr_db=2.0), wrap_decoder=fault)
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_sound_run_is_correct():
    line = _run(tiny(snr_db=2.0))
    assert line["correct"] is True and line["failed"] == 0
    assert line["checked_calls"] >= 1


def test_launch_counter_that_does_not_move_is_not_correct():
    cell = tiny(snr_db=2.0)
    cell.workload["counter"] = "launches"  # the torch path launches no kernel
    line = _run(cell)
    assert line["correct"] is False
    assert line["check"]["launch_off"]["value"] == line["attempted"]


def test_another_implementation_fails_the_run():
    cell = tiny()
    cell.workload["implementation"] = "cuda_long"
    with pytest.raises(RuntimeError, match="implementation"):
        _run(cell)


def test_same_seed_same_inputs():
    from portbench.drivers.receive import stage

    cell = tiny()
    fam = cell.reference_family()
    code = fam.build(cell.config, fam.parse(cell.table_text()))
    a = stage(fam, code, cell.traffic, 2 ** 31 + 99, "cpu")
    b = stage(fam, code, cell.traffic, 2 ** 31 + 99, "cpu")
    c = stage(fam, code, cell.traffic, 2 ** 31 + 98, "cpu")
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert (a[1][..., :code.punctured_front] == 0).all()
