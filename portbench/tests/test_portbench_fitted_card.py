"""On the card, at the 802.11n cell's code (``wifi_1944_r56.ap``): kernel
A's fitted instantiation (five edge slots a lane, ``csrc/bp_layered.cu``)
decodes exactly as the wide one (eight slots a lane) does, at the cell's
5.75 dB and at 2 dB (every frame to 40 sweeps), f32 and bf16, unclocked and
clocked; the occupancy query holds three of its blocks on an SM where the
wide one holds two; ptxas fits it in 56 registers without spills; and a
``Decoder`` call on the code counts a fitted launch.

Both instantiations run on the same code through the library's own call:
the launch passes the widest row as ``max_deg``, the code's 20 (the
fitted one) or 21 (the wide one: 21 edges need six slots over 4 lanes),
whose records have the same words, while every row is walked at its true
degree from the layer pointers."""
import re

import pytest

from portbench.drivers import receive
from portbench.spec import load_cell

CELL = "wifi_1944_r56.ap"
SEED = 4100000023
#: the launch's max_deg, the 20th of ldpc_bp_layered's arguments
MAX_DEG_ARG = 19


def _cell_inputs(card, snr_db: float, dtype: str):
    from myldpccppapi_torch import DecoderConfig

    cell = load_cell(CELL)
    cfg, text = cell.config, cell.table_text()
    fam = cell.reference_family()
    code = fam.build(cfg, fam.parse(text))
    port = cell.program_family().program_code(cfg, text)
    _, llr = receive.stage(fam, code, dict(cell.traffic, sets=1, snr_db=snr_db), SEED, card)
    return port, DecoderConfig(**dict(cfg["decoder"], msg_dtype=dtype)), llr[0]


def _launch(port, cfg, llr, max_deg: int, clocked: bool):
    """One launch at one codeword a block with ``max_deg`` passed as the
    widest row; returns its DecodeResult (``total_iters``: each block's
    sweeps) and the names of the bp_layered kernels a profiler saw (none
    unclocked: the kernel runs clocked only while a profiler records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from myldpccppapi_torch.ops import _build, cuda_bp

    def run():
        result, args = cuda_bp._prepare(port, cfg, llr, 1)
        args = args[:MAX_DEG_ARG] + (max_deg,) + args[MAX_DEG_ARG + 1:]
        assert _build.load().ldpc_bp_layered(*args) == 0
        torch.cuda.synchronize(llr.device)
        return result

    if not clocked:
        return run(), set()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
    cuda = torch.autograd.DeviceType.CUDA
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and "bp_layered_kernel" in e.name()}
    return result, names


@pytest.mark.card
@pytest.mark.parametrize("clocked", [False, True], ids=["unclocked", "clocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("snr_db", [5.75, 2.0])
def test_fitted_decodes_as_the_wide_instantiation(card, snr_db, dtype, clocked):
    import torch

    from myldpccppapi_torch.ops import cuda_bp, cuda_stream

    port, cfg, llr = _cell_inputs(card, snr_db, dtype)
    itemsize = 2 if dtype == "bfloat16" else 4
    assert port.max_row_degree == 20 and cuda_bp.lanes(port) == 4
    assert cuda_bp.edges_per_lane(port) == 5
    assert cuda_stream.record_words(20, itemsize) == cuda_stream.record_words(21, itemsize)
    fitted, fitted_names = _launch(port, cfg, llr, 20, clocked)
    wide, wide_names = _launch(port, cfg, llr, 21, clocked)
    for field in ("bits", "converged", "iterations", "total_iters"):
        assert torch.equal(getattr(fitted, field), getattr(wide, field)), field
    if clocked:
        t = "float" if dtype == "float32" else "__nv_bfloat16"
        (f,), (w,) = fitted_names, wide_names
        assert f"bp_layered_kernel<{t}, 5," in f and "true>" in f, f
        assert f"bp_layered_kernel<{t}, 8," in w and "true>" in w, w
    sweeps = fitted.iterations.float()
    print({"snr_db": snr_db, "dtype": dtype, "clocked": clocked,
           "converged": float(fitted.converged.float().mean()),
           "mean_sweeps": float(sweeps.mean()), "max_sweeps": int(fitted.total_iters.max())})
    if snr_db == 2.0:
        assert int(fitted.iterations.min()) == cfg.max_iters


@pytest.mark.card
def test_three_fitted_blocks_an_sm(card):
    from myldpccppapi_torch import Decoder
    from myldpccppapi_torch.ops import _build, cuda_bp

    port, cfg, llr = _cell_inputs(card, 5.75, "float32")
    lib = _build.load()
    got = {}
    for itemsize in (4, 2):
        for max_deg in (20, 21):
            got[itemsize, max_deg] = lib.ldpc_bp_layered_blocks_per_sm(
                port.n, port.z, port.m_b, port.num_blocks, 0, max_deg, 0, itemsize, 0, 4, 1,
                card.index)
    print({f"itemsize {i}, max_deg {d}": b for (i, d), b in got.items()})
    assert got[4, 20] == 3 and got[4, 21] == 2
    assert cuda_bp._blocks_per_sm(port, card.index, 0, 4) == (3,)
    assert cuda_bp.tile_size(port, card.index, llr.shape[0]) == 1
    dec = Decoder(port, cfg, device=card)
    before = cuda_bp.decode_qc_cuda.fitted_launches, cuda_bp.decode_qc_cuda.launches
    dec(llr)
    after = cuda_bp.decode_qc_cuda.fitted_launches, cuda_bp.decode_qc_cuda.launches
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)


def _ptxas_entries(report: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from ptxas's -v report."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out[name] = (int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return out


@pytest.mark.card
def test_fitted_instantiations_fit_56_registers_without_spills(card):
    from myldpccppapi_torch.ops import _build

    _build.load()
    entries = {k: v for k, v in _ptxas_entries(_build.ptxas_report()).items()
               if "bp_layered_kernel" in k}
    fitted = {k: v for k, v in entries.items() if "Li5E" in k}
    wide_min_sum = {k: v for k, v in entries.items() if "Li8ELb0ELb0ELb0ELb0ELb0E" in k}
    for k, v in sorted({**fitted, **wide_min_sum}.items()):
        print(k, "registers %d, spill stores %d, spill loads %d" % v)
    assert len(fitted) == 4  # f32 and bf16, unclocked and clocked
    for regs, stores, loads in fitted.values():
        assert regs <= 56 and stores == 0 and loads == 0
