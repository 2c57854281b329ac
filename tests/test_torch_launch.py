"""The launch path that kernels A, C and D share (``ops/cuda_launch.py``),
on the CPU: the kernels' plans are built with the card's answers stubbed
(the ``cpu_plans`` fixture, which tests/test_torch_slot_clocks.py and
tests/test_torch_stream.py import) and the kernel library is faked.

* One ``group_slots`` serves every kernel and equals both definitions the
  kernel modules held before it: kernel A's, through its cell table, and
  kernel D's, through adjacent blocks of a layer.  Held on every code the
  port ships and on multi-edge and masked test codes.
* A planned launch derives nothing again: no gate, no lane count, no row
  degree of the code.
* A plan is one cached object per (code, config, device); a ``Decoder``
  resolves it at construction; its argument list has the length and the
  order of the launcher's ctypes signature, for kernels A, C and D.
* A public decode call checks its device inside ``myldpc.<kind>.prepare``.
* A plan names its card: a CUDA device without an index is the current
  one, in the cache's key, in the plan and in a ``Decoder``.

About 25 s alone, on one thread (most of it building DVB-S2's 64800 codes)."""
import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from myldpccppapi_torch import Decoder, DecoderConfig
from myldpccppapi_torch.codes import QCCode, dvbs2, nr_code, regular, rs_ldpc, wifi, wimax
from myldpccppapi_torch.codes.base_matrices import WIFI_SEEDS, WIMAX_SEEDS
from myldpccppapi_torch.codes.dvbs2 import _DEGREE_PROFILES
from myldpccppapi_torch.ops import _build, cuda_bp, cuda_launch, cuda_long, cuda_stream

torch.set_num_threads(1)


@pytest.fixture
def cpu_plans(monkeypatch):
    """Kernel launch plans (ops/cuda_launch.py) on the CPU: the card's
    answers stubbed (132 SMs; kernel A's occupancy, 5 blocks an SM at tiles
    1-4; the long-code fit query, the shared placement; C's scratch, 64
    bytes a codeword), the CUDA stream and device context made no-ops, the
    launch counters restored and the plan caches emptied after."""
    for module in (cuda_bp, cuda_long):
        monkeypatch.setattr(module, "cuda_index", lambda device: 0)
    monkeypatch.setattr(cuda_bp, "_blocks_per_sm",
                        lambda code, index, mode_bits, itemsize: (5,) * 4)
    monkeypatch.setattr(cuda_long, "placement", lambda code, index, itemsize=4: cuda_long.SHARED)
    monkeypatch.setattr(cuda_long, "scratch_bytes", lambda code, sum_product, itemsize: 64)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for decode in (cuda_bp.decode_qc_cuda, cuda_long.decode_qc_long):
        for name, count in list(vars(decode).items()):
            monkeypatch.setattr(decode, name, count)
    for module in (cuda_bp, cuda_long):
        module._plan.cache_clear()
    yield torch.device("cpu")
    for module in (cuda_bp, cuda_long):
        module._plan.cache_clear()


def _multi_edge(cells) -> QCCode:
    """wimax 576 r1/2 with extra circulants ``cells`` ((layer, column,
    shift), ...): two in one cell, or three where a cell takes two."""
    code = wimax(576, "1/2")
    return QCCode(name="multi_edge", base=code.base, z=code.z, extra_blocks=cells)


def _masked() -> QCCode:
    """A small staircase code whose last parity block drops row 0 (the
    masked wrap row of tests/test_torch_long.py's random codes)."""
    base = np.full((3, 7), -1, dtype=np.int32)
    base[:, :4] = [[1, 5, -1, 2], [-1, 3, 7, 0], [6, -1, 4, 1]]
    for i in range(3):
        base[i, 4 + i] = 0
        if i + 1 < 3:
            base[i + 1, 4 + i] = 2
    base[0, 6] = 7
    return QCCode(name="masked", base=base, z=8, masked_rows=(((0, 6, 7), (0,)),))


CODES = {
    **{f"wimax_{n}_{r}": functools.partial(wimax, n, r) for r in WIMAX_SEEDS for n in (576, 2304)},
    **{f"wifi_{n}_{r}": functools.partial(wifi, int(n), r) for n, r in WIFI_SEEDS},
    **{f"nr_bg{bg}_z{z}": functools.partial(nr_code, z, bg) for bg in (1, 2) for z in (32, 384)},
    **{f"dvbs2_{n}_{r}": functools.partial(dvbs2, n, r) for n, r in _DEGREE_PROFILES},
    "regular_648": regular,
    "rs_ldpc_2048": rs_ldpc,
    "rs_ldpc_4_4_8": functools.partial(rs_ldpc, 4, 4, 8),
    "multi_edge": functools.partial(_multi_edge, ((0, 1, 5),)),
    "multi_edge_cells": functools.partial(_multi_edge, ((0, 1, 5), (0, 1, 9), (2, 0, 3),
                                                         (2, 3, 11))),
    "masked": _masked,
}


def _adjacent_groups(code) -> int:
    """Kernel D's former ``group_slots`` (ops/cuda_stream.py): the most
    blocks of a layer that sit next to a block of the same column."""
    _, bc, _ = code.blocks
    ptr = code.layer_ptr
    most = 0
    for i in range(code.m_b):
        cols = bc[ptr[i]:ptr[i + 1]]
        same = cols[1:] == cols[:-1]
        grouped = np.zeros(len(cols), dtype=bool)
        grouped[1:] |= same
        grouped[:-1] |= same
        most = max(most, int(grouped.sum()))
    return most


@pytest.mark.parametrize("make", CODES.values(), ids=CODES.keys())
def test_one_group_slots_for_every_kernel(make):
    code = make()
    got = cuda_launch.group_slots(code)
    assert got == int(cuda_bp.cell_table(code)[code.num_blocks:].max(initial=0))
    assert got == _adjacent_groups(code)


def test_the_test_codes_have_cells_and_masks():
    assert cuda_launch.group_slots(CODES["multi_edge"]()) == 2
    assert cuda_launch.group_slots(CODES["multi_edge_cells"]()) == 3
    assert cuda_launch.n_masks(CODES["masked"]()) == 1
    assert cuda_launch.group_slots(dvbs2(16200, "1/2")) > 0


class FakeLib:
    """Records the kernel library's calls (the library needs a card)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _cases(device):
    """(plan, code) of kernel A (the wifi cell's code), kernel C (DVB-S2
    16200 r1/2, shared) and kernel D (the same code, global)."""
    short, long = wifi(1944, "5/6"), dvbs2(16200, "1/2")
    lazy = DecoderConfig(normalization=0.85, syndrome_mode="lazy")
    return [(functools.partial(cuda_bp.plan, short, DecoderConfig(normalization=0.75), device),
             short),
            (functools.partial(cuda_long.plan, long, lazy, device, cuda_long.SHARED), long),
            (functools.partial(cuda_long.plan, long, lazy, device, cuda_long.GLOBAL), long)]


def test_a_planned_launch_derives_nothing_again(monkeypatch, cpu_plans):
    """Once a plan exists, its lookup and its launches call no gate
    (``supported``), no lane count and no row degree of the code."""
    lib = FakeLib()
    monkeypatch.setattr(cuda_launch._build, "load", lambda: lib)
    cases = [(make, make(), code) for make, code in _cases(cpu_plans)]

    def refuse(*args, **kw):
        raise AssertionError("a planned launch derived it again")
    for module in (cuda_bp, cuda_long):
        monkeypatch.setattr(module, "supported", refuse)
    monkeypatch.setattr(cuda_bp, "lanes", refuse)
    monkeypatch.setattr(QCCode, "row_degrees", property(refuse))
    for make, plan, code in cases:
        assert make() is plan
        for batch in (1, 3, 7, 0, 5):
            res = cuda_launch.launch(plan, torch.zeros((batch, code.n)))
            assert res.bits.shape == (batch, code.n)
    assert [name for name, _ in lib.calls] == (["ldpc_bp_layered"] * 4 + ["ldpc_bp_long"] * 4
                                               + ["ldpc_bp_stream"] * 4)


def _want_ints(plan, code, cfg, batch, tile) -> tuple:
    """The launcher's integer arguments from the batch on, as csrc/ reads
    them."""
    lazy, sp = int(cfg.syndrome_mode == "lazy"), int(cfg.algorithm == "sum-product")
    bf16, gs = int(cfg.msg_dtype == "bfloat16"), cuda_launch.group_slots(code)
    head = (batch, code.n_b, code.z, code.m_b, code.num_blocks)
    if plan.entry == "ldpc_bp_layered":
        return head + (gs, code.max_row_degree, cuda_bp.lanes(code), tile, cfg.max_iters,
                       int(cfg.early_exit), cuda_bp.mode(cfg), bf16, 0)
    if plan.entry == "ldpc_bp_long":
        return head + (cuda_launch.n_masks(code),
                       int((cuda_launch.layer_flags(code) & cuda_launch.MULTI_EDGE).any()),
                       gs, code.max_row_degree, cfg.max_iters, int(cfg.early_exit), lazy, sp,
                       bf16)
    stages = cuda_stream.stage_plan(code)
    return head + (stages.total_cols, stages.max_cols, cuda_launch.n_masks(code), gs,
                   code.max_row_degree, cfg.max_iters, int(cfg.early_exit), lazy, sp, bf16)


@pytest.mark.parametrize("index,entry", enumerate(["ldpc_bp_layered", "ldpc_bp_long",
                                                   "ldpc_bp_stream"]))
def test_plan_is_cached_and_its_args_follow_the_signature(cpu_plans, index, entry):
    """One cached plan per (code, config, device); its arguments: the LLRs'
    and the outputs' pointers, the launcher's scratches and tables, the
    integer arguments, the stream and (unclocked) a null counter, in the
    order and number of ``_SIGNATURES``."""
    make, code = _cases(cpu_plans)[index]
    plan = make()
    assert plan.entry == entry and make() is plan
    assert make.func(code, plan.cfg, torch.device("meta"), *make.args[3:]) is not plan
    other = dataclasses.replace(plan.cfg, max_iters=7)
    assert make.func(code, other, cpu_plans, *make.args[3:]) is not plan
    llr = torch.zeros((3, code.n))
    tile = cuda_launch.choose_tile(3, plan.sms, plan.occupancy) if plan.occupancy else 1
    result, args = cuda_launch.prepare(plan, llr, tile)
    argtypes, _ = _build._SIGNATURES[entry]
    assert len(args) == len(argtypes)
    for value, ctype in zip(args, argtypes):
        ctype(value)  # a pointer or null where a pointer goes, an int where an int goes
    assert args[:6] == (llr.data_ptr(), result.bits.data_ptr(), result.converged.data_ptr(),
                        result.iterations.data_ptr(), result.total_iters.data_ptr(), None)
    tables = tuple(t.data_ptr() for t in plan.tables)
    scratches = {"ldpc_bp_layered": 0, "ldpc_bp_long": 1, "ldpc_bp_stream": 2}[entry]
    at = 6 + scratches + len(tables)
    assert args[6 + scratches:at] == tables
    ints = _want_ints(plan, code, plan.cfg, 3, tile)
    assert args[at:at + len(ints)] == ints
    assert args[at + len(ints)] == 0  # the stream
    if entry == "ldpc_bp_layered":
        assert args[at + len(ints) + 1:] == (None, 0)
    elif entry == "ldpc_bp_stream":
        assert args[at + len(ints) + 1] is None and args[-1] == cuda_stream.queue_entries(
            3, plan.cfg.max_iters)


def test_decoder_resolves_its_plan_at_construction(monkeypatch, cpu_plans):
    """On a CUDA device a kernel ``Decoder`` holds its kernel's cached plan
    (for the config without its acceptance check) and calls the launch
    sequence with it."""
    from myldpccppapi_torch import decoder

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(decoder, "resolve_device", lambda device: cuda)
    nr = nr_code(384, 1)
    for code, kernel in ((wifi(1944, "5/6"), cuda_bp), (nr, cuda_long)):
        dec = Decoder(code, DecoderConfig(normalization=0.75), device="cuda")
        assert dec.implementation == ("cuda" if kernel is cuda_bp else "cuda_long")
        assert dec._fn.func is cuda_launch.launch
        assert dec._fn.args == (kernel.plan(code, DecoderConfig(normalization=0.75), cuda),)
    # under CRC acceptance the wrapped kernel runs the plan of the config
    # without its check: the one above
    crc = Decoder(nr, DecoderConfig(normalization=0.75, crc="24B"), device="cuda")
    assert isinstance(crc._fn, types.FunctionType)
    assert cuda_long._plan.cache_info().currsize == 1


@pytest.mark.parametrize("index", range(3), ids=["A", "C", "D"])
def test_a_plan_names_its_card(monkeypatch, cpu_plans, index):
    """``"cuda"`` is the current card, in the key and in ``Plan.device``: a
    plan made before the current card changes is not the one after."""
    from myldpccppapi_torch.utils import device as device_mod

    for module in (cuda_bp, cuda_long):
        monkeypatch.setattr(module, "cuda_index", device_mod.cuda_index)
    asked = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: asked.append(i) or types.SimpleNamespace(
                            multi_processor_count=132))
    make, _ = _cases("cuda")[index]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    plan = make()
    assert plan.device == torch.device("cuda", 1)
    assert make.func(*make.args[:2], torch.device("cuda", 1), *make.args[3:]) is plan
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    other = make()
    assert other is not plan and other.device == torch.device("cuda", 2)
    # two keys, each with its index: "cuda" and "cuda:1" shared the first
    assert (cuda_bp if index == 0 else cuda_long)._plan.cache_info().currsize == 2
    if index == 0:
        assert asked == [1, 2]  # the SMs of the plan's own card


def test_a_decoder_keeps_to_its_card(monkeypatch, cpu_plans):
    """A ``Decoder`` on ``"cuda"`` is on the card current at construction:
    its device and its plan's name that card."""
    from myldpccppapi_torch import decoder

    monkeypatch.setattr(decoder, "resolve_device", lambda device: torch.device(device))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    dec = Decoder(wifi(1944, "5/6"), DecoderConfig(normalization=0.75), device="cuda")
    assert dec.device == torch.device("cuda", 3)
    assert dec._fn.args[0].device == torch.device("cuda", 3)


@pytest.mark.parametrize("decode,kind,code", [
    (cuda_bp.decode_qc_cuda, "short", wifi(1944, "5/6")),
    (cuda_long.decode_qc_long, "long", nr_code(384, 1)),
], ids=["A", "C-D"])
def test_a_public_call_checks_its_device_inside_prepare(monkeypatch, decode, kind, code):
    """``decode_qc_cuda`` and ``decode_qc_long`` check the LLRs' device (and
    then look up their plan) inside ``myldpc.<kind>.prepare``: a tensor on
    neither the CPU nor a card is refused there, before any launch."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kw):
        raise AssertionError("looked up a plan for a refused device")
    monkeypatch.setattr(cuda_bp if kind == "short" else cuda_long, "plan", refuse)
    llr = torch.zeros((2, code.n), device="meta")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="unsupported device meta"):
            decode(code, DecoderConfig(), llr)
    assert [e.name for e in prof.events() if e.name.startswith("myldpc.")] == [
        f"myldpc.{kind}.prepare"]
