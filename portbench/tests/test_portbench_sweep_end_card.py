"""On the card: kernel A's sweep end (``csrc/bp_layered.cu``).  In the
layered modes without multi-edge cells the last layer's row parities come
from its write-back, and a block runs the exact syndrome pass only in a
sweep where one of its codewords that is not done found every last-layer
row even.

* The clocked kernel's ``syndrome_skips`` (``cuda_bp.slot_clocks()``) equals
  a count taken from the plain version's hard decisions after each sweep:
  at one codeword a block on one of the 802.11n cell's sets
  (``wifi_1944_r56.ap``), and at 3 and 7 codewords a block, early exit on
  and off, on wimax 576 r3/4B (the narrow instantiation).
* Bits, converged flags, iterations and posteriors equal the plain
  version's (``cuda_bp.decode_qc_cuda_plain`` on the card): the cell's sets
  in f32 and bf16, layered sum-product, wimax 576 r3/4B at 8192 frames in
  blocks of 1 to 10 codewords, RS-LDPC 2048 on the xor group, and a
  multi-edge code, whose sweep end is the full pass as before.

The kernels run on the card only; ``tests/test_torch_short_lanes.py``
emulates the same sweep end on the CPU."""
import pytest

from portbench.drivers import receive
from portbench.spec import load_cell

CELL = "wifi_1944_r56.ap"
SEED = 4200000077
FIELDS = ("bits", "converged", "iterations")


def _cell_llr(card, sets: int = 1):
    from myldpccppapi_torch import DecoderConfig

    cell = load_cell(CELL)
    cfg, text = cell.config, cell.table_text()
    fam = cell.reference_family()
    code = fam.build(cfg, fam.parse(text))
    port = cell.program_family().program_code(cfg, text)
    _, llr = receive.stage(fam, code, dict(cell.traffic, sets=sets), SEED, card)
    return port, DecoderConfig(**cfg["decoder"]), llr


def _llr(code, batch: int, snr_db: float, seed: int, card):
    """LLRs of random codewords of ``code`` through BPSK/AWGN, on the card."""
    import numpy as np
    import torch

    from myldpccppapi_torch.codes import encode_numpy, ru_precompute

    rng = np.random.default_rng(seed)
    mats = getattr(code, "encoder_matrices", None) or ru_precompute(code)
    c = encode_numpy(mats, rng.integers(0, 2, size=(batch, mats.w.shape[1]), dtype=np.uint8))
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32)).to(card)


def _odd_last(code, cfg, llr, iters):
    """[S, B] bool, S the most sweeps of any frame: whether a frame has an
    odd row in the code's last block row after sweep s + 1 (the hard
    decisions of a plain decode of that many sweeps), for every frame that
    ran that sweep; False elsewhere."""
    import dataclasses

    import numpy as np
    import torch

    from myldpccppapi_torch.ops import cuda_bp

    br, bc, sh = (np.asarray(x) for x in code.blocks)
    rows = np.arange(code.z)
    last = [torch.as_tensor(bc[e] * code.z + (rows + sh[e]) % code.z, device=llr.device)
            for e in np.flatnonzero(br == code.m_b - 1)]
    steps = int(iters.max())
    odd = torch.zeros((steps, llr.shape[0]), dtype=torch.bool, device=llr.device)
    for s in range(1, steps + 1):
        ran = torch.nonzero(iters >= s).flatten()
        few = dataclasses.replace(cfg, max_iters=s, soft_output=True, early_exit=True)
        hard = cuda_bp.decode_qc_cuda_plain(code, few, llr[ran]).posteriors <= 0
        par = torch.zeros((ran.numel(), code.z), dtype=torch.bool, device=llr.device)
        for cols in last:
            par ^= hard[:, cols]
        odd[s - 1, ran] = par.any(dim=1)
    return odd


def _block_skips(odd, plain, executed, tile: int) -> int:
    """The syndrome skips a launch in blocks of ``tile`` codewords counts:
    for each block and each sweep it ran, a skip where every codeword of
    the block had latched before that sweep or had an odd last-layer row in
    it (a codeword past the batch is done from the start); times the
    tile."""
    import numpy as np

    executed = executed.cpu().numpy().astype(np.int64)
    steps = int(executed.max())
    batch = plain.iterations.numel()
    sweep = np.arange(1, steps + 1)[:, None]
    rows = np.zeros((steps, batch), dtype=bool)
    rows[:odd.shape[0]] = odd.cpu().numpy()[:steps]
    latched = plain.converged.cpu().numpy() & (plain.iterations.cpu().numpy() < sweep)
    ok = np.ones((steps, executed.size * tile), dtype=bool)
    ok[:, :batch] = latched | rows
    skip = ok.reshape(steps, executed.size, tile).all(axis=2) & (sweep <= executed[None, :])
    return int(skip.sum()) * tile


def _launch(code, cfg, llr, tile: int, clocked: bool):
    """One launch of ``tile`` codewords a block through the library's own
    call, clocked under a profiler (of the host and the card, as the
    benchmark's traced runs profile); (its DecodeResult, whose
    ``total_iters`` holds each block's sweeps; the slot counter's rise)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from myldpccppapi_torch.ops import _build, cuda_bp

    before = cuda_bp.slot_clocks() or dict.fromkeys(cuda_bp.SLOT_CLOCKS, 0)
    traced = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with traced if clocked else contextlib.nullcontext():
        result, args = cuda_bp._prepare(code, cfg, llr, tile)
        assert _build.load().ldpc_bp_layered(*args) == 0
        torch.cuda.synchronize(llr.device)
    after = cuda_bp.slot_clocks() or dict.fromkeys(cuda_bp.SLOT_CLOCKS, 0)
    return result, {k: after[k] - before[k] for k in cuda_bp.SLOT_CLOCKS}


def _assert_plain(got, want, posteriors: bool = True):
    import torch

    for field in FIELDS:
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field).cpu()), field
    if posteriors:
        a, b = got.posteriors, want.posteriors
        raw = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert a.dtype == b.dtype and torch.equal(a.view(raw), b.view(raw)), "posteriors"


@pytest.mark.card
def test_clocked_skips_equal_the_plain_count_on_the_cell(card):
    import torch

    from myldpccppapi_torch import Decoder
    from myldpccppapi_torch.ops import cuda_bp

    port, cfg, llr = _cell_llr(card)
    llr = llr[0]
    dec = Decoder(port, cfg, device=card)
    assert dec.implementation == "cuda" and cuda_bp.edges_per_lane(port) == 5
    assert cuda_bp.tile_size(port, card.index, llr.shape[0]) == 1
    plain = cuda_bp.decode_qc_cuda_plain(port, cfg, llr)
    result, got = _launch(port, cfg, llr, 1, clocked=True)
    _assert_plain(result, plain, posteriors=False)
    assert torch.equal(dec(llr).bits, plain.bits)
    odd = _odd_last(port, cfg, llr, plain.iterations)
    want = _block_skips(odd, plain, result.total_iters, 1)
    iters = plain.iterations.long()
    assert want == int(sum(odd[s, iters > s].sum() for s in range(odd.shape[0])))
    print({"frames": llr.shape[0], "frame_sweeps": int(iters.sum()),
           "syndrome_skips": got["syndrome_skips"], "plain_count": want,
           "skip_share_pct": 100.0 * got["syndrome_skips"] / got["block_sweeps"]})
    assert got["launches"] == 1 and got["block_sweeps"] == int(iters.sum())
    assert got["syndrome_skips"] == want
    assert 0 < want < got["block_sweeps"] - int(plain.converged.sum()) + 1


@pytest.mark.card
@pytest.mark.parametrize("early_exit", [True, False], ids=["early-exit", "no-early-exit"])
@pytest.mark.parametrize("tile", [3, 7])
def test_clocked_skips_in_blocks_of_several_codewords(card, tile, early_exit):
    """wimax 576 r3/4B (the narrow instantiation), 2,000 frames at 3 dB
    (most of them past a few sweeps, some at 40), so that the last block
    holds fewer codewords than the tile."""
    from myldpccppapi_torch import DecoderConfig, wimax
    from myldpccppapi_torch.ops import cuda_bp

    code = wimax(576, "3/4B")
    cfg = DecoderConfig(normalization=0.75, max_iters=40, early_exit=early_exit,
                        soft_output=True)
    llr = _llr(code, 2000, 3.0, 4200000101, card)
    plain = cuda_bp.decode_qc_cuda_plain(code, cfg, llr)
    result, got = _launch(code, cfg, llr, tile, clocked=True)
    _assert_plain(result, plain)
    odd = _odd_last(code, cfg, llr, plain.iterations)
    want = _block_skips(odd, plain, result.total_iters, tile)
    print({"tile": tile, "early_exit": early_exit, "block_sweeps": got["block_sweeps"],
           "syndrome_skips": got["syndrome_skips"], "plain_count": want})
    assert got["syndrome_skips"] == want and 0 < want < got["block_sweeps"]


def _multi_edge():
    """wimax 576 r1/2 with ten of layer 2's twelve circulants in multi-edge
    cells (chip_smoke.py phase 3j's second code)."""
    import numpy as np

    from myldpccppapi_torch import QCCode, wimax

    base = np.asarray(wimax(576, "1/2").base)
    extra = tuple((2, j, (int(base[2, j]) + 3 + j) % 24) for j in (3, 4, 5, 7, 11))
    return QCCode(name="wimax576r12_extra_most", base=base, z=24, extra_blocks=extra)


def _wimax_r34b():
    from myldpccppapi_torch import wimax

    return wimax(576, "3/4B")


def _rs_ldpc_2048():
    from myldpccppapi_torch import rs_ldpc

    return rs_ldpc()


CASES = {  # name -> (code, config fields, SNR in dB, frames, tiles)
    "wimax576r34B": (_wimax_r34b, dict(normalization=0.75), 3.0, 8192, (1, 2, 5, 10)),
    "wimax576r34B-sp": (_wimax_r34b, dict(algorithm="sum-product"), 3.0, 2000, (1, 4)),
    "wimax576r34B-bf16": (_wimax_r34b, dict(normalization=0.75, msg_dtype="bfloat16"), 3.0,
                          2000, (1, 6)),
    "rs_ldpc2048": (_rs_ldpc_2048, dict(normalization=0.75, max_iters=20), 5.0, 2048, (1, 2)),
    "multi-edge": (_multi_edge, dict(normalization=0.75), 2.0, 1000, (1, 3)),
}


@pytest.mark.card
@pytest.mark.parametrize("early_exit", [True, False], ids=["early-exit", "no-early-exit"])
@pytest.mark.parametrize("name", list(CASES))
def test_sweep_end_decodes_as_the_plain_version(card, name, early_exit):
    from myldpccppapi_torch import DecoderConfig
    from myldpccppapi_torch.ops import cuda_bp

    make, kw, snr_db, frames, tiles = CASES[name]
    code = make()
    cfg = DecoderConfig(**{"max_iters": 40, **kw, "early_exit": early_exit,
                           "soft_output": True})
    llr = _llr(code, frames, snr_db, 4200000200 + len(name), card)
    plain = cuda_bp.decode_qc_cuda_plain(code, cfg, llr)
    for tile in tiles:
        result, _ = _launch(code, cfg, llr, tile, clocked=False)
        _assert_plain(result, plain)
    print({"case": name, "early_exit": early_exit, "tiles": tiles,
           "converged": float(plain.converged.float().mean()),
           "max_sweeps": int(plain.iterations.max())})


@pytest.mark.card
@pytest.mark.parametrize("mode", ["f32", "bf16", "sum-product"])
def test_cell_sets_decode_as_the_plain_version(card, mode):
    """Four of the cell's sets through a ``Decoder``: its f32 configuration
    (the fitted instantiation), bf16 (the fitted one's bf16) and layered
    sum-product (the wide one), soft output on."""
    import dataclasses

    from myldpccppapi_torch import Decoder
    from myldpccppapi_torch.ops import cuda_bp

    port, cfg, llr = _cell_llr(card, sets=4)
    extra = {"f32": {}, "bf16": {"msg_dtype": "bfloat16"},
             "sum-product": {"algorithm": "sum-product", "normalization": 1.0}}[mode]
    cfg = dataclasses.replace(cfg, soft_output=True, **extra)
    dec = Decoder(port, cfg, device=card)
    assert dec.implementation == "cuda"
    for x in llr:
        _assert_plain(dec(x), cuda_bp.decode_qc_cuda_plain(port, cfg, x))
