"""The roofline count against hand counts at the configuration's size, and
the trace arithmetic the per-layer readers use."""
import pytest

from portbench import roofline
from portbench.metrics_common import kernel_roofline_pct
from portbench.spec import metric_reader
from portbench.trace import Trace, covered, merge

H100 = roofline.peaks_of("NVIDIA H100 80GB HBM3")


def test_peaks():
    assert H100 == {"f32_ops_per_s": 33.5e12, "bytes_per_s": 3.35e12}
    assert roofline.peaks_of("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("edges,n,batch,sweeps,ops,nbytes,least", [
    # DVB-S2 64800 r1/2: 1024 frames at 15 sweeps each, bound by operations
    (226799, 64800, 1024, 15360, 34_836_326_400, 331_781_120, 34_836_326_400 / 33.5e12),
    # the same at 15.5 mean sweeps, as the gateway's reference reads
    (226799, 64800, 1024, 15872, 35_997_537_280, 331_781_120, 35_997_537_280 / 33.5e12),
    # one sweep of 32 frames: bound by bytes
    (226799, 64800, 32, 1, 2_267_990, 10_368_160, 10_368_160 / 3.35e12),
])
def test_hand_counts(edges, n, batch, sweeps, ops, nbytes, least):
    assert roofline.decode_ops(edges, sweeps) == ops
    assert roofline.decode_bytes(n, batch) == nbytes
    assert roofline.least_seconds(ops, nbytes, H100) == pytest.approx(least, rel=1e-12)


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def _trace():
    ev = [_Event("portbench.slice", 0, 1000, False),
          _Event("portbench.call", 0, 500, False), _Event("portbench.call", 500, 500, False),
          _Event("portbench.sync", 300, 200, False),
          _Event("portbench.slice", 0, 1000, True),  # the span's device copy
          _Event("void bp_stream_kernel<float>(Params)", 100, 300, True),
          _Event("Memcpy DtoH", 350, 100, True),
          _Event("void bp_stream_kernel<float>(Params)", 600, 300, True)]
    return Trace(ev)


def test_trace_arithmetic():
    assert merge([(5, 9), (0, 2), (1, 3), (8, 10)]) == [(0, 3), (5, 10)]
    assert covered([(0, 3), (5, 10)], 2, 6) == 2
    tr = _trace()
    assert (tr.window_ns, tr.busy_ns) == (1000, 650)
    assert tr.kernel_ns("bp_stream_kernel") == 600
    assert tr.host_gap_ns("call") == [150, 200]
    assert tr.idle_gaps() == [(0, 100), (450, 600), (900, 1000)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["void bp_stream_kernel<float>(Params)", 6e-7]
    assert bd["idle_gaps"][0] == ["call", 1.5e-7]


def test_readers_on_a_trace():
    ctx = {"trace": _trace(), "peaks": H100, "slice_sets": [0, 1], "slice_launches": 2,
           "code": {"n": 64800, "edges": 226799, "batch": 1024},
           "ref_sweeps": {0: 15360, 1: 15360}}
    least = 2 * 34_836_326_400 / 33.5e12
    assert kernel_roofline_pct(ctx, "bp_stream_kernel") == pytest.approx(100 * least / 600e-9)
    assert kernel_roofline_pct(ctx, "bp_long_kernel") is None
    assert metric_reader("device_idle_pct")(ctx) == pytest.approx(35.0)
    assert metric_reader("host_gap_ms")(ctx) == pytest.approx(175e-6)
    assert metric_reader("launches_per_call")(ctx) == 1.0
