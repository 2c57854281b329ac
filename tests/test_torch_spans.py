"""The program's spans (``utils/profiling.py``): ranges named ``myldpc.*``
that exist only while a torch profiler records, and cost a flag read and a
shared null context otherwise.

About 5 s alone, on one thread."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myldpccppapi_torch import Decoder, DecoderConfig
from myldpccppapi_torch.codes import wimax
from myldpccppapi_torch.utils import profiling, recording, span

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_is_the_shared_null_context_while_no_profiler_records(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a range was made while no profiler records")
    monkeypatch.setattr(profiling, "_Range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not recording()
    got = span("decode")
    assert got is span("long.launch")
    assert isinstance(got, contextlib.nullcontext)
    with span("decode"):
        with span("long.prepare"):
            pass


def test_span_records_a_named_range_under_the_profiler():
    with _cpu_profile() as prof:
        assert recording()
        with span("outer"):
            with span("inner"):
                torch.ones(2).sum()
    assert not recording()
    by_name = {e.name: e for e in prof.events()}
    outer, inner = by_name["myldpc.outer"], by_name["myldpc.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


@pytest.mark.parametrize("implementation", ["auto", "torch"])
def test_decoder_call_records_the_decode_span(implementation):
    """A ``Decoder`` call on the CPU is the ``myldpc.decode`` span; the CPU
    path opens none of the long-code wrapper's spans."""
    code = wimax(576, "1/2")
    dec = Decoder(code, DecoderConfig(max_iters=3, implementation=implementation),
                  device="cpu")
    llr = np.full((2, code.n), 2.0, dtype=np.float32)
    with _cpu_profile() as prof:
        res = dec(llr)
    names = [e.name for e in prof.events() if e.name.startswith("myldpc.")]
    assert names == ["myldpc.decode"]
    assert bool(res.converged.all())


def test_short_code_wrapper_opens_no_span_on_the_cpu():
    """Kernel A's wrapper on a CPU tensor runs its plain version and opens
    none of its ``myldpc.short.*`` spans (they are the CUDA branch's)."""
    from myldpccppapi_torch.codes import wifi
    from myldpccppapi_torch.ops import cuda_bp

    code = wifi(1944, "5/6")
    cfg = DecoderConfig(normalization=0.75, max_iters=3)
    llr = torch.full((2, code.n), 2.0)
    with _cpu_profile() as prof:
        res = cuda_bp.decode_qc_cuda(code, cfg, llr)
    assert not [e.name for e in prof.events() if e.name.startswith("myldpc.")]
    assert bool(res.converged.all())
