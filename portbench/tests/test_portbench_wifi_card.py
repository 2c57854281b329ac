"""On the card, at the 802.11n cell's size (``wifi_1944_r56.ap``): the
clocked kernel A (``csrc/bp_layered.cu``, run while a profiler records)
decodes as the unclocked one does and its slot counter adds up; the
program's spans reach the trace as host ranges only; and the control,
kernel A's own bf16 instantiation in the place of the f32 one the
configuration states, comes out not correct on three seeds."""
import time

import pytest

from portbench.drivers import receive
from portbench.run import run_cell
from portbench.spec import load_cell

CELL = "wifi_1944_r56.ap"
SEED = 3000000023
BF16 = {"msg_dtype": "bfloat16"}


@pytest.mark.card
def test_clocked_kernel_decodes_as_the_unclocked_one(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from myldpccppapi_torch import Decoder, DecoderConfig
    from myldpccppapi_torch.ops import cuda_bp

    cell = load_cell(CELL)
    cfg, text = cell.config, cell.table_text()
    fam = cell.reference_family()
    code = fam.build(cfg, fam.parse(text))
    port = cell.program_family().program_code(cfg, text)
    dec = Decoder(port, DecoderConfig(**cfg["decoder"]), device=card)
    assert dec.implementation == "cuda"
    _, llr = receive.stage(fam, code, dict(cell.traffic, sets=1), SEED, card)
    plain = dec(llr[0])
    torch.cuda.synchronize(card)
    before = cuda_bp.slot_clocks() or dict.fromkeys(cuda_bp.SLOT_CLOCKS, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clocked = dec(llr[0])
        torch.cuda.synchronize(card)
    after = cuda_bp.slot_clocks()
    for field in ("bits", "converged", "iterations"):
        assert torch.equal(getattr(clocked, field), getattr(plain, field)), field
    assert int(clocked.total_iters) == int(plain.total_iters)
    got = {k: after[k] - before[k] for k in cuda_bp.SLOT_CLOCKS}
    batch = llr.shape[1]
    tile = cuda_bp.tile_size(port, card.index, batch)
    occupancy = 100.0 * got["resident_ns"] / got["slot_ns"]
    print({**got, "tile": tile, "occupancy_pct": occupancy})
    assert got["launches"] == 1 and got["blocks"] == -(-batch // tile)
    assert got["frame_sweeps"] == int(plain.iterations.sum())
    assert got["frame_sweeps"] <= got["block_sweeps"] <= got["blocks"] * tile * 40
    assert 0.0 < occupancy <= 100.0
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.name() for e in events if e.device_type() == cuda and "bp_layered" in e.name()}
    assert len(kernels) == 1 and "true" in kernels.pop()  # the clocked instantiation
    spans = [(e.name(), e.device_type()) for e in events if e.name().startswith("myldpc.")]
    assert {n for n, _ in spans} == {"myldpc.decode", "myldpc.short.prepare",
                                     "myldpc.short.launch", "myldpc.short.finish"}
    assert all(d != cuda for _, d in spans)


@pytest.mark.card
def test_control_fails_on_card(card):
    cell = load_cell(CELL)
    # the sampled calls among the first ones, which a short window reaches
    cell.traffic["check_within"] = cell.traffic["check_calls"]
    for seed in (4000000011, 4000000012, 4000000013):
        line = run_cell(cell, seed, 3.0, False, time.time(), decoder_overrides=BF16)
        print(CELL, seed, {k: c["value"] for k, c in line["check"].items()})
        assert line["correct"] is False
