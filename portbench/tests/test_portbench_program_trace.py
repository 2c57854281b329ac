"""The readers of the program's own tracing (``portbench/program_trace.py``)
on synthetic inputs, and the benchmark's existing readers unchanged by the
program's spans in the trace."""
import pytest

from portbench import program_trace
from portbench.spec import metric_reader
from portbench.tests.test_portbench_roofline import H100, _Event
from portbench.trace import Trace

#: what the program adds to the slice of ``_trace()``: host ranges only (a
#: span of the program has no device-side copy; the card test checks that)
PROGRAM = [_Event("myldpc.decode", 10, 90, False),
           _Event("myldpc.long.prepare", 20, 40, False),
           _Event("myldpc.long.launch", 60, 20, False),
           _Event("myldpc.long.finish", 85, 10, False),
           _Event("myldpc.decode", 510, 80, False),
           _Event("myldpc.long.prepare", 520, 30, False),
           _Event("myldpc.long.launch", 560, 20, False)]


def _ctx(trace):
    return {"trace": trace, "peaks": H100, "slice_sets": [0, 1], "slice_launches": 2,
            "code": {"n": 64800, "edges": 226799, "batch": 1024},
            "ref_sweeps": {0: 15360, 1: 15360}}


#: the slice of test_portbench_roofline's ``_trace()``
BASE = [_Event("portbench.slice", 0, 1000, False),
        _Event("portbench.call", 0, 500, False), _Event("portbench.call", 500, 500, False),
        _Event("portbench.sync", 300, 200, False),
        _Event("portbench.slice", 0, 1000, True),
        _Event("void bp_stream_kernel<float>(Params)", 100, 300, True),
        _Event("Memcpy DtoH", 350, 100, True),
        _Event("void bp_stream_kernel<float>(Params)", 600, 300, True)]


def test_existing_readers_ignore_the_program_spans():
    plain, with_program = Trace(BASE), Trace(BASE + PROGRAM)
    for name in ("bp_stream_roofline", "device_idle_pct", "host_gap_ms", "launches_per_call"):
        assert metric_reader(name)(_ctx(with_program)) == metric_reader(name)(_ctx(plain))
    assert with_program.breakdown() == plain.breakdown()
    assert dict(with_program.spans) == dict(plain.spans)
    assert with_program.busy == plain.busy
    assert with_program.idle_gaps() == plain.idle_gaps()
    assert [with_program.span_at(t) for t in (50, 350, 700)] == \
        [plain.span_at(t) for t in (50, 350, 700)]


def test_program_spans_keep_the_host_ranges():
    spans = program_trace.program_spans(PROGRAM + [_Event("myldpc.decode", 0, 5, True),
                                                   _Event("portbench.call", 0, 500, False)])
    assert spans == {"decode": [(10, 100), (510, 590)], "long.prepare": [(20, 60), (520, 550)],
                     "long.launch": [(60, 80), (560, 580)], "long.finish": [(85, 95)]}
    assert program_trace.program_spans([]) == {}


def test_span_arithmetic():
    spans = program_trace.program_spans(PROGRAM)
    # decode 90 and 80 ns less their children (70 and 50): 20 + 30 over 2 calls
    assert program_trace.self_ms(spans, "decode", 0, 1000, 2) == pytest.approx(25e-6)
    assert program_trace.mean_ms(spans, "long.prepare", 0, 1000, 2) == pytest.approx(35e-6)
    assert program_trace.mean_ms(spans, "long.launch", 0, 1000, 2) == pytest.approx(20e-6)
    # only the spans inside the window count
    assert program_trace.mean_ms(spans, "long.launch", 0, 500, 1) == pytest.approx(20e-6)
    for fn in (program_trace.self_ms, program_trace.mean_ms):
        assert fn(spans, "long.other", 0, 1000, 2) is None
        assert fn(spans, "decode", 0, 1000, 0) is None
        assert fn({}, "decode", 0, 1000, 2) is None


def test_idle_unspanned():
    tr = Trace(BASE)  # calls [0, 500] and [500, 1000]; busy [100, 450] and [600, 900]
    spans = program_trace.program_spans(PROGRAM)
    # call 1: idle [0, 100] less decode's [10, 100], and [450, 500]: 10 + 50;
    # call 2: idle [500, 600] less decode's [510, 590], and [900, 1000]: 20 + 100
    assert program_trace.idle_unspanned_ms(tr, spans) == pytest.approx(90e-6)
    host_gap = metric_reader("host_gap_ms")(_ctx(tr))
    assert program_trace.idle_unspanned_ms(tr, spans) <= host_gap
    assert program_trace.idle_unspanned_ms(tr, {}) is None
    assert program_trace.idle_unspanned_ms(Trace([]), spans) is None


PHASES = {"stage": 400, "pass1": 1000, "pass2": 1200, "sweep_end": 300, "resident": 3000,
          "sweeps": 4}


@pytest.mark.parametrize("phase", ["stage", "pass1", "pass2", "sweep_end"])
def test_cycle_readers(monkeypatch, phase):
    from myldpccppapi_torch.ops import cuda_stream

    read = metric_reader(f"stream_{phase}_cycles")
    monkeypatch.setattr(cuda_stream, "phase_cycles", lambda: dict(PHASES))
    assert read({}) == PHASES[phase] / 4
    monkeypatch.setattr(cuda_stream, "phase_cycles", lambda: dict(PHASES, sweeps=0))
    assert read({}) is None
    monkeypatch.setattr(cuda_stream, "phase_cycles", lambda: None)
    assert read({}) is None
    monkeypatch.delattr(cuda_stream, "phase_cycles")  # a program without the counter
    assert read({}) is None
