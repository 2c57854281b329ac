"""The control: the program's own lower-precision path, bf16 messages,
in the place of the f32 one the configuration states, must come out not
correct.  On the CPU at a small size; on the card at each cell's own size
on three seeds."""
import time

import pytest

from portbench.run import run_cell
from portbench.tests.cells import RECEIVE, tiny

BF16 = {"msg_dtype": "bfloat16"}


def test_control_fails_on_cpu():
    line = run_cell(tiny(snr_db=2.0, batch=32), 11, 0.5, False, time.time(), device="cpu",
                    decoder_overrides=BF16)
    assert line["correct"] is False
    assert line["check"]["iters_off"]["value"] > 0


def test_program_passes_on_cpu():
    line = run_cell(tiny(snr_db=2.0, batch=32), 11, 0.5, False, time.time(), device="cpu")
    assert line["correct"] is True, line["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", RECEIVE)
def test_control_fails_on_card(card, name):
    from portbench.spec import load_cell

    cell = load_cell(name)
    # the sampled calls among the first ones, which a short window reaches
    cell.traffic["check_within"] = cell.traffic["check_calls"]
    for seed in (4000000001, 4000000002, 4000000003):
        line = run_cell(cell, seed, 3.0, False, time.time(), decoder_overrides=BF16)
        print(name, seed, {k: c["value"] for k, c in line["check"].items()})
        assert line["correct"] is False

