"""On the card: the program's tracing at the gateway cell's size.  The
clocked kernel (``csrc/bp_stream.cu``, run while a profiler records)
decodes as the unclocked one does; its four phases account for the
blocks' resident cycles; its sweeps are the frames' iterations; and the
program's spans reach the trace as host ranges only."""
import pytest

from portbench.drivers import receive
from portbench.spec import load_cell

CELL = "dvbs2_64800_r12.gateway"
SEED = 3000000019


@pytest.mark.card
def test_clocked_kernel_decodes_as_the_unclocked_one(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from myldpccppapi_torch import Decoder, DecoderConfig
    from myldpccppapi_torch.ops import cuda_stream

    cell = load_cell(CELL)
    cfg, text = cell.config, cell.table_text()
    fam = cell.reference_family()
    code = fam.build(cfg, fam.parse(text))
    dec = Decoder(cell.program_family().program_code(cfg, text),
                  DecoderConfig(**cfg["decoder"]), device=card)
    _, llr = receive.stage(fam, code, dict(cell.traffic, sets=1), SEED, card)
    plain = dec(llr[0])
    torch.cuda.synchronize(card)
    before = cuda_stream.phase_cycles() or dict.fromkeys(cuda_stream.PHASE_SLOTS, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clocked = dec(llr[0])
        torch.cuda.synchronize(card)
    after = cuda_stream.phase_cycles()
    for field in ("bits", "converged", "iterations"):
        assert torch.equal(getattr(clocked, field), getattr(plain, field)), field
    got = {k: after[k] - before[k] for k in cuda_stream.PHASE_SLOTS}
    phases = sum(got[k] for k in cuda_stream.PHASES)
    print({**got, "phases_over_resident": phases / got["resident"],
           "per_frame_sweep": {k: got[k] / got["sweeps"] for k in cuda_stream.PHASES}})
    assert got["sweeps"] == int(plain.iterations.sum())
    assert 0.90 * got["resident"] <= phases <= got["resident"]
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.name() for e in events if e.device_type() == cuda and "bp_stream" in e.name()}
    assert len(kernels) == 1 and "true" in kernels.pop()  # the clocked instantiation
    spans = [(e.name(), e.device_type()) for e in events if e.name().startswith("myldpc.")]
    assert {n for n, _ in spans} == {"myldpc.decode", "myldpc.long.prepare",
                                     "myldpc.long.launch", "myldpc.long.finish"}
    assert all(d != cuda for _, d in spans)
