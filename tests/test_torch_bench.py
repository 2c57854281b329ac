"""The port's headline bench (``myldpccppapi_torch/bench.py``) on the CPU:
its record's convergence and mean iterations are those of a plain
``Decoder(implementation="torch")`` call on the same staged LLRs, its
baseline is the port's C++ golden, and a failed gate raises."""
import numpy as np
import pytest
import torch

from myldpccppapi_torch import Decoder, Encoder, bench, native
from myldpccppapi_torch.codes import wimax

torch.set_num_threads(1)


def test_record_equals_plain_decoder_on_the_same_llrs():
    record = bench.measure(device="cpu", batch=64, reps=2)
    code = wimax(576, "3/4B")
    u, llrs = bench.stage(code, torch.device("cpu"), 64, 3, bench.SEED)
    dec = Decoder(code, bench.CONFIG, device="cpu", implementation="torch")
    results = [dec(llr) for llr in llrs[1:]]  # the timed realizations
    frames = 2 * 64
    unconv = sum(int((~r.converged).sum()) for r in results)
    assert record["conv"] == 1.0 - unconv / frames
    assert record["mean_iters"] == sum(int(r.iterations.sum()) for r in results) / frames
    assert record["bit_errors"] == sum(int((dec.info_bits(r) != u).sum()) for r in results)
    assert record["implementation"] == "torch" and record["kernel_launches"] == [0, 0]
    assert record["batch_ms"] == float(np.median(record["ms"])) and len(record["ms"]) == 2
    assert record["vs_baseline"] == pytest.approx(record["value"] / record["cpu_baseline_mbits"])


def test_staged_realizations_are_distinct_codewords_of_one_batch():
    code = wimax(576, "3/4B")
    u, llrs = bench.stage(code, torch.device("cpu"), 16, 3, 7)
    assert u.shape == (16, code.k) and all(x.shape == (16, code.n) for x in llrs)
    assert not torch.equal(llrs[0], llrs[1]) and not torch.equal(llrs[1], llrs[2])
    # one codeword batch under every realization: at 5 dB each hard
    # decision is the codeword's bit but for ~4% of the bits
    cw = Encoder(code, device="cpu")(u)
    for llr in llrs:
        assert ((llr < 0).to(torch.uint8) == cw).float().mean() > 0.9


def test_baseline_is_the_native_golden(monkeypatch):
    calls = []
    real = native.decode_golden_native

    def spy(code, llr, **kw):
        calls.append((llr.shape, kw))
        return real(code, llr, **kw)

    monkeypatch.setattr(native, "decode_golden_native", spy)
    code = wimax(576, "3/4B")
    _, llrs = bench.stage(code, torch.device("cpu"), 300, 1, 0)
    assert bench.cpu_baseline_mbits(code, llrs[0].numpy()) > 0
    assert calls == [((256, code.n), {"max_iters": 40})] * 3


@pytest.mark.parametrize("gate", ["convergence", "bit errors"])
def test_failed_gate_raises(gate, monkeypatch):
    if gate == "convergence":
        monkeypatch.setattr(bench, "SNR_DB", 2.0)
        match = "convergence"
    else:
        # converged frames that decode to a wrong codeword: the gate counts
        # bit errors against unconverged frames x k
        monkeypatch.setattr(Decoder, "info_bits", lambda self, res: 1 - res.bits[:, :432])
        match = "bit errors"
    with pytest.raises(RuntimeError, match=match):
        bench.measure(device="cpu", batch=64, reps=2)
