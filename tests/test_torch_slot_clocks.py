"""Kernel A's slot clocks (``ops/cuda_bp.py``, ``csrc/bp_layered.cu``) on the
CPU: the fold of a launch's per-block entry and exit times, tile, sweeps,
iterations and skipped syndrome passes into the counter's slots, pinned on
hand-made launches; the
counter and its pointer go to the library only while a profiler records a
decode that has a clocked instantiation (kernel A's plans, on the CPU with
the card's answers stubbed: the ``cpu_plans`` fixture); the library call
lies inside the ``myldpc.short.launch`` span; the benchmark's reader of the slots finds
nothing where no counter exists, and the reader of the skip share nothing
where the counter has no such slot; a launch of the fitted instantiation is
counted, and the benchmark's reader of the fitted share reads the counts;
the occupancy query offers the fitted code only the tiles its instantiation
holds.  The kernel itself runs on the card only
(``portbench/tests/test_portbench_wifi_card.py``).

About 6 s alone, on one thread."""
import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myldpccppapi_torch.codes import wifi, wimax
from myldpccppapi_torch.codes.rs_ldpc import rs_ldpc
from myldpccppapi_torch.ops import cuda_bp, cuda_launch
from myldpccppapi_torch.utils.config import DecoderConfig
from myldpccppapi_torch.utils.profiling import span
from test_torch_launch import cpu_plans  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _occupancy(got):
    return 100.0 * got["resident_ns"] / got["slot_ns"]


def test_fold_one_wave():
    """Four blocks on four slots, each resident for the whole launch: every
    slot busy."""
    got = cuda_bp.fold_slot_clocks([100, 100, 100, 100], [900, 900, 900, 900], 1,
                                   [5, 5, 5, 5], [3, 5, 4, 2], slots=4)
    assert got == {"resident_ns": 3200, "slot_ns": 3200, "frame_sweeps": 14,
                   "block_sweeps": 20, "blocks": 4, "launches": 1, "syndrome_skips": 0}
    assert _occupancy(got) == 100.0


def test_fold_lone_straggler_in_the_last_wave():
    """Two slots, a second wave whose last block runs 40 sweeps alone on
    the emptied card: the share of slot-time it leaves idle."""
    entry = [0, 0, 10, 12]
    leave = [10, 12, 20, 100]
    got = cuda_bp.fold_slot_clocks(entry, leave, 1, [4, 5, 4, 40], [4, 5, 4, 40], slots=2)
    assert got["resident_ns"] == 10 + 12 + 10 + 88
    assert got["slot_ns"] == 2 * 100
    assert _occupancy(got) == pytest.approx(60.0)
    assert got["frame_sweeps"] == got["block_sweeps"] == 53


def test_fold_partial_last_tile():
    """Five codewords in tiles of two: the last block holds one codeword
    and a ghost, and counts its sweeps for both slots of its tile; the
    frame-sweeps count the five codewords."""
    got = cuda_bp.fold_slot_clocks([5, 7, 9], [25, 27, 19], 2, [3, 4, 2], [3, 2, 4, 1, 2],
                                   slots=3)
    assert got == {"resident_ns": 20 + 20 + 10, "slot_ns": 3 * (27 - 5),
                   "frame_sweeps": 12, "block_sweeps": 18, "blocks": 3, "launches": 1,
                   "syndrome_skips": 0}


def test_fold_syndrome_skips():
    """Three blocks of two codewords: each block's sweeps whose syndrome
    pass it skipped count for both slots of its tile, the last block's
    ghost too, as its block-sweeps do."""
    got = cuda_bp.fold_slot_clocks([5, 7, 9], [25, 27, 19], 2, [3, 4, 2], [3, 2, 4, 1, 2],
                                   slots=3, skips=[2, 3, 0])
    assert got["syndrome_skips"] == 10 and got["block_sweeps"] == 18
    assert cuda_bp.fold_slot_clocks([0], [9], 1, [40], [40], 1, skips=[38])[
        "syndrome_skips"] == 38


def test_slot_clocks_is_none_before_any_clocked_launch(monkeypatch):
    monkeypatch.setattr(cuda_bp, "_slot_counters", {})
    assert cuda_bp.slot_clocks() is None


def test_slot_counter_starts_idle_and_sums_over_streams(monkeypatch):
    monkeypatch.setattr(cuda_bp, "_slot_counters", {})
    a = cuda_bp.slot_counter("cpu", 0)
    assert a is cuda_bp.slot_counter("cpu", 0)
    assert a.dtype == torch.int64
    assert a.tolist() == [0] * len(cuda_bp.SLOT_CLOCKS) + [-1, 0, 0]
    b = cuda_bp.slot_counter("cpu", 7)
    a[:7] = torch.arange(1, 8)
    b[:7] = 10
    assert cuda_bp.slot_clocks() == dict(zip(cuda_bp.SLOT_CLOCKS,
                                             [11, 12, 13, 14, 15, 16, 17]))


class FakeLib:
    """Records the kernel library's calls (the library needs a card)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            torch.ones(1)  # an operator the profiler records inside the call
            self.calls.append((name, args))
            return 0
        return call


def _args(code, cfg, device, batch=3, tile=2):
    llr = torch.zeros((batch, code.n), dtype=torch.float32)
    return cuda_launch.prepare(cuda_bp.plan(code, cfg, device), llr, tile)[1]


@pytest.mark.parametrize("recording,code,cfg,clocked", [
    (False, wifi(1944, "5/6"), DecoderConfig(normalization=0.75), False),
    (True, wifi(1944, "5/6"), DecoderConfig(normalization=0.75), True),
    (True, wimax(576, "3/4B"), DecoderConfig(msg_dtype="bfloat16"), True),
    (True, wifi(1944, "5/6"), DecoderConfig(schedule="flooding"), False),
    (True, wifi(1944, "5/6"), DecoderConfig(algorithm="sum-product"), False),
    (True, rs_ldpc(4, 4, 8), DecoderConfig(), False),
], ids=["idle", "wifi", "wimax-bf16", "flooding", "sum-product", "xor"])
def test_launch_passes_the_slot_counter_while_a_profiler_records(
        monkeypatch, cpu_plans, recording, code, cfg, clocked):
    """The slot counter's pointer and the launch's slots (132 SMs times 5
    blocks of the tile an SM) go to the library only while a torch profiler
    records a layered min-sum decode of a cyclic code without multi-edge
    cells; else null and 0, and the library runs the unclocked kernel."""
    monkeypatch.setattr(cuda_bp, "_slot_counters", {})
    with contextlib.ExitStack() as held:
        if recording:
            held.enter_context(profile(activities=[ProfilerActivity.CPU]))
        args = _args(code, cfg, cpu_plans)
    argtypes, _ = cuda_bp._build._SIGNATURES["ldpc_bp_layered"]
    assert len(args) == len(argtypes) == 30
    assert args[13:22] == (3, code.n_b, code.z, code.m_b, code.num_blocks,
                           cuda_launch.group_slots(code), code.max_row_degree,
                           cuda_bp.lanes(code), 2)
    if clocked:
        assert args[28] == cuda_bp.slot_counter("cpu", 0).data_ptr() and args[29] == 660
    else:
        assert args[28] is None and args[29] == 0 and cuda_bp._slot_counters == {}


def test_multi_edge_code_runs_unclocked():
    code = wimax(576, "1/2")
    code = type(code)(name="me", base=code.base, z=code.z, extra_blocks=((0, 1, 5),))
    assert cuda_launch.group_slots(code) > 0
    assert not cuda_bp.clocked(code, DecoderConfig())


def test_run_calls_the_library_inside_the_launch_span(monkeypatch, cpu_plans):
    """Under a profiler a launch is ``myldpc.short.prepare``, ``.launch``
    (holding the library call) and ``.finish``, one after another; it counts
    one launch and returns the largest block sweep count; a failed launch
    raises."""
    lib = FakeLib()
    monkeypatch.setattr(cuda_launch._build, "load", lambda: lib)
    code, cfg = wifi(1944, "5/6"), DecoderConfig(normalization=0.75)
    plan = cuda_bp.plan(code, cfg, cpu_plans)
    executed = torch.tensor([3, 9], dtype=torch.int32)
    result = cuda_bp.DecodeResult(torch.empty((3, code.n), dtype=torch.uint8),
                                  torch.empty(3, dtype=torch.bool),
                                  torch.empty(3, dtype=torch.int32), executed)
    for counter in ("launches", "soft_launches", "bf16_launches", "xor_launches",
                    "multi_edge_launches", "fitted_launches"):  # restored after
        monkeypatch.setattr(cuda_bp.decode_qc_cuda, counter,
                            getattr(cuda_bp.decode_qc_cuda, counter))
    before = cuda_bp.decode_qc_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("short.prepare"):
            args = (1, 2)
        res = cuda_launch.run(plan, result, args, 1)
    assert lib.calls == [("ldpc_bp_layered", (1, 2))]
    assert cuda_bp.decode_qc_cuda.launches == before + 1 and int(res.total_iters) == 9
    assert res.bits is result.bits and res.posteriors is None
    assert cuda_launch.run(plan, result, None, 1) is result  # an empty batch: no launch
    events = prof.events()
    spans = sorted((e for e in events if e.name.startswith("myldpc.short.")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == ["myldpc.short.prepare", "myldpc.short.launch",
                                       "myldpc.short.finish"]
    op, = [e for e in events if e.name == "aten::ones"]
    assert spans[1].time_range.start <= op.time_range.start
    assert op.time_range.end <= spans[1].time_range.end
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(spans, spans[1:]))
    monkeypatch.setattr(cuda_launch._build, "load",
                        lambda: types.SimpleNamespace(ldpc_bp_layered=lambda *a: 700))
    with pytest.raises(RuntimeError, match="bp_layered kernel launch failed: CUDA error 700"):
        cuda_launch.run(plan, result, args, 1)


@pytest.mark.parametrize("code,cfg,tile,fitted", [
    (wifi(1944, "5/6"), DecoderConfig(normalization=0.75), 1, 1),
    (wifi(1944, "5/6"), DecoderConfig(normalization=0.75, msg_dtype="bfloat16"), 1, 1),
    (wifi(1944, "5/6"), DecoderConfig(schedule="flooding"), 1, 0),
    (wifi(1944, "3/4"), DecoderConfig(normalization=0.75), 1, 0),
    (wimax(576, "5/6"), DecoderConfig(), 4, 1),
    (wimax(576, "5/6"), DecoderConfig(), 5, 0),
    (wimax(576, "3/4B"), DecoderConfig(), 1, 0),
], ids=["wifi", "wifi-bf16", "flooding", "wifi-r34", "wimax-tile4", "wimax-tile5", "narrow"])
def test_run_counts_fitted_launches(monkeypatch, cpu_plans, code, cfg, tile, fitted):
    """``decode_qc_cuda.fitted_launches`` counts a launch that the fitted
    instantiation serves, beside ``launches``."""
    monkeypatch.setattr(cuda_launch._build, "load", lambda: FakeLib())
    for counter in ("launches", "soft_launches", "bf16_launches", "xor_launches",
                    "multi_edge_launches", "fitted_launches"):
        monkeypatch.setattr(cuda_bp.decode_qc_cuda, counter, 0)
    result = cuda_bp.DecodeResult(torch.empty((1, code.n), dtype=torch.uint8),
                                  torch.empty(1, dtype=torch.bool),
                                  torch.empty(1, dtype=torch.int32),
                                  torch.tensor([4], dtype=torch.int32))
    cuda_launch.run(cuda_bp.plan(code, cfg, cpu_plans), result, (1, 2), tile)
    assert cuda_bp.decode_qc_cuda.launches == 1
    assert cuda_bp.decode_qc_cuda.fitted_launches == fitted


def test_fitted_share_reader(monkeypatch):
    """The share of launches the fitted instantiation ran, in %: None
    without the counter (a program before it) or without a launch."""
    from portbench.spec import metric_reader

    read = metric_reader("bp_layered_fitted_share")
    decode = cuda_bp.decode_qc_cuda
    monkeypatch.setattr(decode, "launches", 0)
    monkeypatch.setattr(decode, "fitted_launches", 0)
    assert read({}) is None  # no launch counted
    monkeypatch.setattr(decode, "launches", 19)
    monkeypatch.setattr(decode, "fitted_launches", 19)
    assert read({}) == 100.0
    monkeypatch.setattr(decode, "fitted_launches", 0)
    assert read({}) == 0.0
    monkeypatch.delattr(decode, "fitted_launches")
    assert read({}) is None


@pytest.mark.parametrize("code,mode_bits,tiles", [
    (wifi(1944, "5/6"), 0, [1]),                 # 324 threads a codeword
    (wimax(576, "5/6"), 0, [1, 2, 3, 4]),        # fitted: up to 384 threads
    (wimax(576, "5/6"), 1, [1, 2, 3, 4, 5]),     # flooding, wide: up to 512
    (wimax(576, "3/4B"), 0, list(range(1, 11))),  # narrow: up to 1024
], ids=["wifi", "wimax-r56", "wimax-r56-flooding", "narrow"])
def test_occupancy_query_asks_the_tiles_of_the_instantiation(monkeypatch, code, mode_bits,
                                                            tiles):
    lib = FakeLib()
    lib.ldpc_bp_layered_blocks_per_sm = lambda *a: lib.calls.append(a) or 3
    monkeypatch.setattr(cuda_bp._build, "load", lambda: lib)
    got = cuda_bp._blocks_per_sm.__wrapped__(code, 0, mode_bits, 4)
    assert [a[10] for a in lib.calls] == tiles and got == (3,) * len(tiles)
    assert all(cuda_bp.edges_per_lane(code, mode_bits, t) == cuda_bp.edges_per_lane(code, mode_bits)
               for t in tiles)


def test_occupancy_reader_finds_nothing_without_a_counter(monkeypatch):
    from portbench.spec import metric_reader

    read = metric_reader("bp_layered_slot_occupancy")
    monkeypatch.setattr(cuda_bp, "_slot_counters", {})
    assert read({}) is None
    counter = cuda_bp.slot_counter("cpu", 0)
    assert read({}) is None  # a counter that counted no launch
    counter[:6] = torch.tensor([600, 1000, 9, 9, 2, 1])
    assert read({}) == pytest.approx(60.0)
    monkeypatch.delattr(cuda_bp, "slot_clocks")  # a program without the clocks
    assert read({}) is None


def test_syndrome_skip_share_reader(monkeypatch):
    """The share of block-sweeps whose syndrome pass was skipped, in %: None
    without a counter, with a counter that counted no sweep, or from a
    program whose counter has no such slot."""
    from portbench.spec import metric_reader

    read = metric_reader("bp_layered_syndrome_skip_share")
    monkeypatch.setattr(cuda_bp, "_slot_counters", {})
    assert read({}) is None
    counter = cuda_bp.slot_counter("cpu", 0)
    assert read({}) is None  # no sweep counted
    counter[:7] = torch.tensor([600, 1000, 9, 40, 2, 1, 25])
    assert read({}) == pytest.approx(62.5)
    monkeypatch.setattr(cuda_bp, "slot_clocks",  # a program before the slot
                        lambda: dict(zip(cuda_bp.SLOT_CLOCKS[:6], [600, 1000, 9, 40, 2, 1])))
    assert read({}) is None
    monkeypatch.delattr(cuda_bp, "slot_clocks")
    assert read({}) is None


def test_fold_matches_the_kernels_slot_order():
    got = cuda_bp.fold_slot_clocks(np.array([1]), np.array([2]), 1, [1], [1], 1)
    assert tuple(got) == cuda_bp.SLOT_CLOCKS
