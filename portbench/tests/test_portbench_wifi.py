"""The 802.11n configuration (``configs/wifi_1944_r56.json``) on the CPU: its
table equals the port's; the reference's code equals the port's
``QCCode``; the reference's encoder gives codewords; the reference decoder
equals the port's plain torch path bit for bit, iterations and converged
flags included, at the threshold and below it where frames run all 40
sweeps; the cell loads; and a run of the cell cut to the CPU comes out
correct, and not correct under each fault of ``tests/faults.py``.

About 10 s in one process on one thread."""
import copy
import hashlib
import json
import time

import numpy as np
import pytest
import torch

from myldpccppapi_torch import Decoder, DecoderConfig
from myldpccppapi_torch.codes.base_matrices import WIFI_SEEDS
from portbench.reference import qc as rqc
from portbench.reference import wifi as rwf
from portbench.run import run_cell
from portbench.spec import HERE, load_cell
from portbench.tests.faults import altered, half_batch, unchanged

torch.set_num_threads(1)

CELL = "wifi_1944_r56.ap"
CFG = json.loads((HERE / "configs" / "wifi_1944_r56.json").read_text())
TEXT = (HERE / "configs" / CFG["table"]).read_text()
FRAMES = 64


def _ref():
    return rwf.build(CFG, rwf.parse(TEXT))


def _port():
    return load_cell(CELL).program_family().program_code(CFG, TEXT)


def _frames(seed: int, snr_db: float):
    code = _ref()
    gen = torch.Generator().manual_seed(seed)
    u = torch.randint(0, 2, (FRAMES, code.k), generator=gen, dtype=torch.uint8)
    sigma = 10.0 ** (-snr_db / 20.0)
    x = 1.0 - 2.0 * rwf.encode(code, u).float()
    y = x + sigma * torch.randn(x.shape, generator=gen)
    return u, (2.0 / sigma ** 2) * y


def test_table_is_the_ports_and_its_hash_the_configurations():
    assert hashlib.sha256(TEXT.encode()).hexdigest() == CFG["table_sha256"]
    assert [list(r) for r in rwf.parse(TEXT)] == WIFI_SEEDS[("1944", "5/6")].tolist()
    assert len(TEXT.splitlines()) == 4


def test_reference_code_equals_the_ports():
    ref, port = _ref(), _port()
    assert (ref.n, ref.k, ref.m, ref.edges, ref.z) == (port.n, port.k, port.m,
                                                        port.num_edges, port.z)
    assert (ref.n, ref.k, ref.edges) == (CFG["n"], CFG["k"], CFG["edges"])
    h = port.h_dense()
    assert ref.h_sets() == [set(np.nonzero(row)[0].tolist()) for row in h]
    assert [len(c) for c in ref.layers()] == [20, 20, 20, 19]


def test_encoded_codewords_meet_every_check():
    code = _ref()
    u = torch.randint(0, 2, (FRAMES, code.k), generator=torch.Generator().manual_seed(5),
                      dtype=torch.uint8)
    cw = rwf.encode(code, u)
    assert torch.equal(cw[:, :code.k], u)
    assert bool(rqc.syndrome_ok(code, cw).all())
    assert bool(rqc.syndrome_ok(code, torch.zeros_like(cw)).all())


def test_encoder_refuses_another_parity_structure():
    table = [list(r) for r in rwf.parse(TEXT)]
    table[1][20] = 7  # a fourth entry in the first parity column
    code = rwf.build(CFG, table)
    with pytest.raises(ValueError, match="first parity column"):
        rwf.encode(code, torch.zeros((1, code.k), dtype=torch.uint8))


@pytest.mark.parametrize("snr_db,seed", [(5.0, 2 ** 31 + 11), (5.75, 2 ** 31 + 12)])
def test_reference_decoder_equals_the_ports_torch_path(snr_db, seed):
    code = _ref()
    _, llr = _frames(seed, snr_db)
    d = CFG["decoder"]
    dec = Decoder(_port(), DecoderConfig(**d, implementation="torch"), device="cpu")
    got = dec(llr)
    want = rqc.decode(code, llr, alpha=d["normalization"], beta=d["offset"],
                      max_iters=d["max_iters"], early_exit=d["early_exit"])
    assert torch.equal(got.bits.to(torch.uint8), want.bits)
    assert torch.equal(got.converged.bool(), want.converged)
    assert torch.equal(got.iterations.to(torch.int32), want.iterations)
    if snr_db == 5.0:  # below the threshold: frames that never latch
        assert int((want.iterations == d["max_iters"]).sum()) >= 8
        assert not bool(want.converged.all())


def test_the_cell_loads():
    cell = load_cell(CELL)
    assert cell.config["name"] == "wifi_1944_r56" and cell.chips == 1
    assert cell.traffic == {"driver": "receive", "batch": 4096, "snr_db": 5.75, "sets": 128,
                            "warmup_s": 1.0, "check_calls": 2, "check_within": 256,
                            "trace_start": 60, "trace_calls": 16}
    assert cell.workload == {"implementation": "cuda", "counter": None,
                             "kernel": "bp_layered_kernel"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct", "host_gap_ms", "bp_layered_roofline", "bp_layered_slot_occupancy"}
    assert {m["name"] for m in cell.end_to_end} == {"info_mbps", "call_p95_ms", "setup_s"}


def _tiny():
    """The cell on the CPU: a batch of 8, 2 sets, the torch path (which
    moves no kernel counter)."""
    cell = copy.deepcopy(load_cell(CELL))
    cell.traffic.update(batch=8, sets=2, warmup_s=0.0, check_calls=2, check_within=2,
                        trace_start=2, trace_calls=1)
    cell.workload = dict(cell.workload, implementation="torch")
    return cell


def _run(**kw):
    return run_cell(_tiny(), 2 ** 31 + 21, 0.5, False, time.time(), device="cpu", **kw)


def test_sound_cpu_run_is_correct():
    line = _run()
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    assert line["checked_calls"] >= 1


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_comes_out_not_correct(fault):
    line = _run(wrap_decoder=fault)
    assert line["correct"] is False
    assert line["failed"] >= 1
