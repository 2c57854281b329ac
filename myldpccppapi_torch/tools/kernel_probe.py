"""Probe where a layered BP kernel's time goes on one CUDA GPU.

    python -m myldpccppapi_torch.tools.kernel_probe [--out probe.json]
    python -m myldpccppapi_torch.tools.kernel_probe --long [--out probe.json]
    python -m myldpccppapi_torch.tools.kernel_probe --modes [--out probe.json]
    python -m myldpccppapi_torch.tools.kernel_probe --long-modes [--out probe.json]
    python -m myldpccppapi_torch.tools.kernel_probe --bf16 [--out probe.json]
    python -m myldpccppapi_torch.tools.kernel_probe --xor [--out probe.json]

Without ``--long`` it probes the short-code kernel (csrc/bp_layered.cu).
At bench.py's operating point (wimax 576 r3/4B, batch 8192, layered NMS
alpha 0.75, 40 iterations, triage 5; noise from a torch.Generator on the
card) it measures, with CUDA events (median of 9 after a warm-up, with the
min and max):

- the kernel's single pass at 5 dB with early exit on and off, and the
  frames' iteration counts;
- one codeword alone (one thread block) and one full wave (the codewords
  every SM holds at once in blocks of one, from the kernel library's
  occupancy query), early exit off, at 40 sweeps and at 1 sweep: (t40 -
  t1) / 39 of the lone codeword is one codeword's latency per sweep, which
  sets the straggler tail;
- the triage ``Decoder`` call, its fast pass and its straggler pass (the
  cap of frames, those that failed the fast pass first), each at the tile
  the wrapper picks for its batch;
- the device's busy share of the ``Decoder`` call, from one
  ``torch.profiler`` window: the union of the device events' intervals over
  the wall time of the same calls (the profiler's own host cost lengthens
  that wall time, so the share is a lower bound);
- the single pass and the ``Decoder`` call at 2 dB;
- a tile sweep: single pass and triage decode for several codewords per
  thread block (those that fit), each held bit-exact against the tile the
  wrapper picks.

With ``--long`` it probes the long-code kernels at two operating points,
with CUDA events as above: the NR path's (NR BG1 Z=384, rv0 over the full
buffer, layered NMS alpha 0.8, 30 iterations, batch 512, 5 dB; posterior
in shared memory, csrc/bp_long.cu) and BASELINE config 3's (DVB-S2 64800
r1/2, alpha 0.85, 30 iterations, lazy syndrome, batch 1024, 1.4 dB;
posterior in global memory, csrc/bp_stream.cu, the port of kernel D);
noise from a torch.Generator on the card.  For each:

- one thread block alone, one full wave of blocks (the blocks every SM
  holds at once, from the kernel library's occupancy query) and the full
  batch, early exit off, at 30 sweeps and at 1 sweep: (t30 - t1) / 29 is
  the time of one sweep of each, beside the device-memory bytes one sweep
  moves and the rate that makes: in shared memory the messages R (min-sum:
  a record per row and layer; sum-product: per edge), read and written
  once; in global memory the stage plan's bytes
  (``cuda_stream.stream_bytes``: P columns loaded and written, R records
  read and written);
- the batch with early exit on, its iteration counts, and the ``Decoder``
  call with its device busy share from one profiler window; for DVB-S2
  also the kernel in exact mode.

With ``--modes`` it probes the short-code kernel's modes at the same
operating point (batch 8192, 5 dB, 40 iterations, single pass): layered
min-sum alpha 0.75 (the reference row), flooding min-sum alpha 0.75, SCMS,
flooding and layered sum-product, and layered and flooding soft output.
For each, with CUDA events as above: the tile (codewords per block) and
lanes per row, the batch with early exit on and its iteration counts,
and one codeword alone (one block) and the batch with early exit off at
40 sweeps and at 1 sweep, whose difference over 39 is the time of one
sweep.

With ``--long-modes`` it probes the long-code kernel's modes at the
``--long`` operating points: at NR BG1 Z=384 (batch 512, 5 dB) layered
min-sum alpha 0.8 (the reference row), sum-product, soft output,
sum-product with soft output and bf16 min-sum; at DVB-S2 16200 r1/2 (batch
1024, 1.5 dB, lazy, alpha 0.85; shared memory) min-sum; at DVB-S2 64800
r1/2 (batch 1024, 1.4 dB, posterior in global memory) min-sum lazy and
exact, soft output, and sum-product exact and lazy.  For each, as
``--modes`` does: the batch with early exit on and its iteration counts,
and one thread block alone and the batch with early exit off at 30 sweeps
and at 1 sweep, whose difference over 29 is the time of one sweep.

With ``--bf16`` it sets f32 and bf16 messages side by side at the
``--long`` points and at bench.py's point: kernel C at NR BG1 Z=384 and
at DVB-S2 64800 r1/2 (bf16 in the placement its fit picks, global, and
forced into shared memory) as ``--long`` does, with the bytes per sweep at the
message's item size, and kernel A's layered mode as ``--modes`` does.

With ``--xor`` it probes kernel A's xor group at the RS-LDPC main path
(rs_ldpc() = (2048, 1723), batch 2048, 6.5 dB, layered NMS alpha 0.75)
and, beside it, its cyclic layered mode at BASELINE config 2 (wifi 1944
r5/6, batch 4096, 6.5 dB, alpha 0.75), each as ``--modes`` does (40
sweeps against 1), plus the RS-LDPC ``Decoder`` call's device busy
share (20 iterations) from one profiler window.

It prints one line per measurement and, with ``--out``, writes them as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess
import time

import torch
import torch.profiler

from .. import Decoder, DecoderConfig, Encoder, dvbs2, nr_code, rs_ldpc, wifi, wimax
from ..codes.dvbs2 import ira_encode_fn
from ..codes.nr import rate_match_bits, rate_match_llr, triangular_encode_fn
from ..ops import _build, cuda_bp, cuda_launch, cuda_long, cuda_stream
from ..ops.bp import msg_dtype
from ..ops.channel import transmit
from ..ops.cuda_bp import _blocks_per_sm, decode_qc_cuda, lanes, mode, tile_size
from ..ops.cuda_long import GLOBAL, SHARED, blocks_per_sm, decode_qc_long, placement
from ..ops.triage import decode_two_phase

BATCH = 8192
#: bench.py's operating point
BENCH_CFG = DecoderConfig(normalization=0.75, max_iters=40, triage_iters=5)
SINGLE = dataclasses.replace(BENCH_CFG, triage_iters=0)
FAST = dataclasses.replace(SINGLE, max_iters=BENCH_CFG.triage_iters)
NO_EXIT = dataclasses.replace(SINGLE, early_exit=False)
TILES = (1, 2, 4, 8, 12, 16)
FIELDS = ("bits", "converged", "iterations", "total_iters")
#: the NR path's operating point (benchmarks/run_baseline.py config 4)
LONG_BATCH = 512
LONG_CFG = DecoderConfig(normalization=0.8, max_iters=30)
#: BASELINE config 3 (benchmarks/run_baseline.py config3)
DVB_BATCH = 1024
DVB_CFG = DecoderConfig(normalization=0.85, max_iters=30, syndrome_mode="lazy")


def timed(fn, reps: int = 9) -> dict:
    """CUDA-event milliseconds of ``fn()``: median, min and max of ``reps``
    calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def busy_share(fn, calls: int = 5) -> dict:
    """Device busy time over wall time of ``calls`` calls of ``fn``, both
    from one torch.profiler window; plus device time per kernel name."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    per_name: dict[str, float] = {}
    for e in device:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": calls, "device_events": len(device),
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us if device else None,
            "device_ms_by_kernel": {k[:90]: v / 1e3 for k, v in top}}


def channel(code, snr_db: float, seed: int, batch: int = BATCH) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, 2, (batch, code.k_info), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, Encoder(code, device="cuda")(u), snr_db)
    return llr.contiguous()


def same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def nr_channel(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """Rate-matched (rv0, full buffer) BPSK/AWGN LLRs of random NR
    codewords, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, 2, (batch, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    e = code.n - code.punctured_front
    tx = rate_match_bits(code, triangular_encode_fn(code)(u), e)
    llr_e, _ = transmit(gen, tx, snr_db)
    return rate_match_llr(code, llr_e, e).contiguous()


def dvbs2_channel(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """BPSK/AWGN LLRs of random DVB-S2 codewords, encoded on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, 2, (batch, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, ira_encode_fn(code)(u), snr_db)
    return llr.contiguous()


def iteration_stats(res) -> dict:
    return {"mean": res.iterations.float().mean().item(),
            "max": int(res.iterations.max()), "total_iters": int(res.total_iters),
            "unconverged": int((~res.converged).sum())}


def probe_long_code(code, cfg, batch: int, llr_all, force: int = 0) -> dict:
    """Per-sweep times of one block, one full wave and the batch (early
    exit off), the bytes they move, and the batch decoded with early exit
    (kernel and, unless ``force`` (SHARED or GLOBAL) overrides the fit's
    placement, ``Decoder``), for ``code`` under ``cfg``, from the rows of
    ``llr_all`` (repeated where a wave needs more)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    item = msg_dtype(cfg).itemsize
    place = force or placement(code, torch.cuda.current_device(), item)
    per_sm = blocks_per_sm(code, cfg, place)
    wave = sms * per_sm
    out: dict = {"code": code.name, "placement": "global" if place == GLOBAL else "shared",
                 "syndrome_mode": cfg.syndrome_mode, "sms": sms,
                 "blocks_per_sm": per_sm, "batch": batch}
    if place == GLOBAL:
        out["bytes_per_codeword_sweep"] = cuda_stream.stream_bytes(
            code, item, cfg.algorithm == "sum-product")
    no_exit = dataclasses.replace(cfg, early_exit=False)
    one_sweep = dataclasses.replace(no_exit, max_iters=1)
    sweeps = no_exit.max_iters
    decode = functools.partial(decode_qc_long, _place=force)
    for name, n_cw in (("one_block", 1), ("one_wave", wave), ("batch", batch)):
        x = llr_all[torch.arange(n_cw, device=llr_all.device) % len(llr_all)]
        full = timed(lambda: decode(code, no_exit, x))
        one = timed(lambda: decode(code, one_sweep, x))
        per_sweep = (full["median"] - one["median"]) / (sweeps - 1)
        if place == GLOBAL:
            # the stage plan's traffic of a sweep after the first
            moved = {k: n_cw * v for k, v in cuda_stream.stream_bytes(
                code, item, cfg.algorithm == "sum-product").items()}
        else:
            # each sweep after the first reads and writes every message of R
            # (min-sum: a record per row and layer)
            r = cuda_long.scratch_bytes(code, cfg.algorithm == "sum-product", item)
            moved = {"r_read": n_cw * r, "r_written": n_cw * r}
        total = sum(moved.values())
        out[name] = {"codewords": n_cw, f"{sweeps}_sweeps": full,
                     "1_sweep": one, "ms_per_sweep": per_sweep,
                     **{f"{k}_bytes_per_sweep": v for k, v in moved.items()},
                     "bytes_per_sweep": total,
                     "gbytes_per_s": total / (per_sweep * 1e-3) / 1e9}
    llr = llr_all[:batch].contiguous()
    out["iterations"] = iteration_stats(decode(code, cfg, llr))
    out["kernel"] = timed(lambda: decode(code, cfg, llr))
    if force:
        return out
    dec = Decoder(code, cfg, device="cuda")
    if dec.implementation != "cuda_long":
        raise RuntimeError(f"{code.name} Decoder resolved to {dec.implementation}")
    out["decoder"] = timed(lambda: dec(llr))
    out["decoder_profiled"] = busy_share(lambda: dec(llr))
    return out


#: the short-code kernel's modes (--modes), at bench.py's operating point
#: without triage
MODES = {
    "layered": SINGLE,
    "flooding": DecoderConfig(schedule="flooding", normalization=0.75, max_iters=40),
    "scms": DecoderConfig(schedule="flooding", self_correction=True, max_iters=40),
    "sp_flooding": DecoderConfig(schedule="flooding", algorithm="sum-product",
                                 max_iters=40),
    "sp_layered": DecoderConfig(algorithm="sum-product", max_iters=40),
    "soft_layered": DecoderConfig(normalization=0.75, max_iters=40, soft_output=True),
    "soft_flooding": DecoderConfig(schedule="flooding", normalization=0.75,
                                   max_iters=40, soft_output=True),
}


def probe_mode(code, cfg, llr) -> dict:
    """The short-code kernel in ``cfg``'s mode on ``llr``: its tile and
    lanes, the batch with early exit and its iteration counts, and one
    codeword alone (one block) and the batch with early exit off, per
    sweep."""
    no_exit = dataclasses.replace(cfg, early_exit=False)
    one_sweep = dataclasses.replace(no_exit, max_iters=1)
    tile = tile_size(code, torch.cuda.current_device(), llr.shape[0], mode(cfg),
                     msg_dtype(cfg).itemsize)
    row = {"tile": tile, "lanes": lanes(code),
           "iterations": iteration_stats(decode_qc_cuda(code, cfg, llr)),
           "batch": timed(lambda: decode_qc_cuda(code, cfg, llr))}
    for what, x in (("one_block", llr[:1].contiguous()), ("batch_no_exit", llr)):
        full = timed(lambda: decode_qc_cuda(code, no_exit, x))
        one = timed(lambda: decode_qc_cuda(code, one_sweep, x))
        row[what] = {"40_sweeps": full, "1_sweep": one,
                     "ms_per_sweep": (full["median"] - one["median"]) / 39}
    return row


def probe_modes(seed: int) -> dict:
    code = wimax(576, "3/4B")
    llr = channel(code, 5.0, seed)
    return {f"mode_{name}": probe_mode(code, cfg, llr) for name, cfg in MODES.items()}


def probe_xor(seed: int) -> dict:
    cfg = DecoderConfig(normalization=0.75, max_iters=40)
    code = rs_ldpc()
    llr = channel(code, 6.5, seed, batch=2048)
    dec = Decoder(code, dataclasses.replace(cfg, max_iters=20), device="cuda")
    out = {"rs_ldpc_2048": probe_mode(code, cfg, llr),
           "rs_ldpc_2048_decoder_profiled": busy_share(lambda: dec(llr))}
    code = wifi(1944, "5/6")
    out["wifi_1944_r56"] = probe_mode(code, cfg, channel(code, 6.5, seed + 1, batch=4096))
    return out


def probe_bf16(seed: int) -> dict:
    """f32 and bf16 messages side by side (f32, bf16, then bf16 again and
    f32, so that a drift of the card's clocks shows)."""
    bf16 = dict(msg_dtype="bfloat16")
    code = wimax(576, "3/4B")
    llr = channel(code, 5.0, seed)
    out: dict = {}
    for name in ("a_f32", "a_bf16", "a_bf16_again", "a_f32_again"):
        cfg = dataclasses.replace(SINGLE, **bf16) if "bf16" in name else SINGLE
        out[name] = probe_mode(code, cfg, llr)
    code = nr_code(384, 1)
    llr = nr_channel(code, LONG_BATCH, 5.0, seed)
    for name in ("nr_f32", "nr_bf16"):
        cfg = dataclasses.replace(LONG_CFG, **bf16) if "bf16" in name else LONG_CFG
        out[name] = probe_long_code(code, cfg, LONG_BATCH, llr)
    code = dvbs2(64800, "1/2")
    llr = dvbs2_channel(code, DVB_BATCH, 1.4, seed + 1)
    cfg = dataclasses.replace(DVB_CFG, **bf16)
    out["dvbs2_64800_f32"] = probe_long_code(code, DVB_CFG, DVB_BATCH, llr)
    out["dvbs2_64800_bf16"] = probe_long_code(code, cfg, DVB_BATCH, llr)
    out["dvbs2_64800_bf16_forced_shared"] = probe_long_code(code, cfg, DVB_BATCH, llr,
                                                            force=SHARED)
    return out


#: the long-code kernel's modes (--long-modes) at each operating point
LONG_MODES = {
    "nr": {"min_sum": LONG_CFG,
           "sum_product": DecoderConfig(algorithm="sum-product", max_iters=30),
           "soft": dataclasses.replace(LONG_CFG, soft_output=True),
           "sum_product_soft": DecoderConfig(algorithm="sum-product", max_iters=30,
                                             soft_output=True),
           "bf16": dataclasses.replace(LONG_CFG, msg_dtype="bfloat16")},
    "dvbs2_16200": {"min_sum": DVB_CFG},
    "dvbs2_64800": {"min_sum": DVB_CFG,
                    "exact": dataclasses.replace(DVB_CFG, syndrome_mode="exact"),
                    "soft": dataclasses.replace(DVB_CFG, soft_output=True),
                    "sum_product": DecoderConfig(algorithm="sum-product", max_iters=30),
                    "sum_product_lazy": DecoderConfig(algorithm="sum-product", max_iters=30,
                                                      syndrome_mode="lazy")},
}


def probe_long_modes(seed: int) -> dict:
    points = {"nr": (nr_code(384, 1), nr_channel(nr_code(384, 1), LONG_BATCH, 5.0, seed)),
              "dvbs2_16200": (dvbs2(16200, "1/2"),
                              dvbs2_channel(dvbs2(16200, "1/2"), DVB_BATCH, 1.5, seed + 2)),
              "dvbs2_64800": (dvbs2(64800, "1/2"),
                              dvbs2_channel(dvbs2(64800, "1/2"), DVB_BATCH, 1.4, seed + 1))}
    out: dict = {}
    for point, (code, llr) in points.items():
        for name, cfg in LONG_MODES[point].items():
            no_exit = dataclasses.replace(cfg, early_exit=False)
            one_sweep = dataclasses.replace(no_exit, max_iters=1)
            row = {"iterations": iteration_stats(decode_qc_long(code, cfg, llr)),
                   "batch": timed(lambda: decode_qc_long(code, cfg, llr))}
            for what, x in (("one_block", llr[:1].contiguous()), ("batch_no_exit", llr)):
                full = timed(lambda: decode_qc_long(code, no_exit, x))
                one = timed(lambda: decode_qc_long(code, one_sweep, x))
                row[what] = {"30_sweeps": full, "1_sweep": one,
                             "ms_per_sweep": (full["median"] - one["median"]) / 29}
            out[f"{point}_{name}"] = row
    return out


def probe_long(seed: int) -> dict:
    code = nr_code(384, 1)
    llr_all = nr_channel(code, LONG_BATCH, 5.0, seed)
    out = {"nr_5dB": probe_long_code(code, LONG_CFG, LONG_BATCH, llr_all)}
    code = dvbs2(64800, "1/2")
    llr_all = dvbs2_channel(code, DVB_BATCH, 1.4, seed + 1)
    out["dvbs2_64800_1.4dB"] = probe_long_code(code, DVB_CFG, DVB_BATCH, llr_all)
    exact = dataclasses.replace(DVB_CFG, syndrome_mode="exact")
    out["dvbs2_64800_1.4dB"]["exact_iterations"] = iteration_stats(
        decode_qc_long(code, exact, llr_all))
    out["dvbs2_64800_1.4dB"]["exact_kernel"] = timed(
        lambda: decode_qc_long(code, exact, llr_all))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--long", action="store_true",
                    help="probe the long-code kernel at NR BG1 Z=384 and "
                         "DVB-S2 64800 r1/2")
    ap.add_argument("--modes", action="store_true",
                    help="probe the short-code kernel's flooding, SCMS, "
                         "sum-product and soft-output modes")
    ap.add_argument("--long-modes", action="store_true", dest="long_modes",
                    help="probe the long-code kernel's sum-product and "
                         "soft-output modes")
    ap.add_argument("--bf16", action="store_true",
                    help="probe f32 against bf16 messages on both kernels")
    ap.add_argument("--xor", action="store_true",
                    help="probe the short-code kernel's xor group at RS-LDPC "
                         "(2048, 1723) beside its cyclic mode at wifi 1944")
    ap.add_argument("--out", help="write the measurements as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: CUDA is not available")
    out: dict = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]}
    print(out["card"], flush=True)
    if args.long:
        out.update(probe_long(args.seed))
    elif args.bf16:
        out.update(probe_bf16(args.seed))
    elif args.long_modes:
        out.update(probe_long_modes(args.seed))
    elif args.modes:
        out.update(probe_modes(args.seed))
    elif args.xor:
        out.update(probe_xor(args.seed))
    else:
        out.update(probe_short(args.seed))
    for key, val in out.items():
        print(f"{key}: {json.dumps(val)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def probe_short(seed: int) -> dict:
    out: dict = {}
    code = wimax(576, "3/4B")
    dev = torch.cuda.current_device()
    tile = tile_size(code, dev, BATCH)
    resident = _blocks_per_sm(code, dev, 0, 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out.update(tile=tile, lanes=lanes(code), sms=sms, blocks_per_sm=resident[tile - 1])
    llr5 = channel(code, 5.0, seed)
    llr2 = channel(code, 2.0, seed + 1)
    dec = Decoder(code, BENCH_CFG, device="cuda")

    res = decode_qc_cuda(code, SINGLE, llr5)
    iters = res.iterations
    out["iterations_5dB"] = {
        "mean": iters.float().mean().item(),
        "frames_at_max_iters": int((iters == SINGLE.max_iters).sum()),
        "unconverged": int((~res.converged).sum())}
    out["single_5dB"] = timed(lambda: decode_qc_cuda(code, SINGLE, llr5))
    out["single_5dB_no_exit"] = timed(lambda: decode_qc_cuda(code, NO_EXIT, llr5))
    one_sweep = dataclasses.replace(NO_EXIT, max_iters=1)
    for name, batch in (("one_block", 1), ("one_wave", sms * resident[0])):
        x = llr5[:batch].contiguous()
        out[f"{name}_40_sweeps"] = timed(lambda: decode_qc_cuda(code, NO_EXIT, x))
        out[f"{name}_1_sweep"] = timed(lambda: decode_qc_cuda(code, one_sweep, x))
    out["sweep_latency_us"] = 1e3 * (out["one_block_40_sweeps"]["median"]
                                     - out["one_block_1_sweep"]["median"]) / 39

    out["decoder_5dB"] = timed(lambda: dec(llr5))
    bad = ~decode_qc_cuda(code, FAST, llr5).ok
    cap = max(8, int(BATCH * BENCH_CFG.triage_cap_frac))
    stragglers = llr5[torch.argsort((~bad).to(torch.uint8), stable=True)[:cap]]
    out["fast_pass_failures"] = int(bad.sum())
    out["straggler_cap"] = cap
    out["fast_pass_5dB"] = timed(lambda: decode_qc_cuda(code, FAST, llr5))
    out["straggler_pass_5dB"] = timed(lambda: decode_qc_cuda(code, SINGLE, stragglers))
    out["decoder_5dB_profiled"] = busy_share(lambda: dec(llr5))

    out["single_2dB"] = timed(lambda: decode_qc_cuda(code, SINGLE, llr2))
    out["decoder_2dB"] = timed(lambda: dec(llr2))

    want = {snr: decode_qc_cuda(code, SINGLE, x) for snr, x in ((5, llr5), (2, llr2))}
    sweep = {}
    plans = {cfg: cuda_bp.plan(code, cfg, llr5.device) for cfg in (SINGLE, FAST)}
    for t in sorted({x for x in TILES if x <= len(resident)} | {tile}):
        def single(x, t=t):
            return cuda_launch.launch(plans[SINGLE], x, t)

        def triage(x, t=t):
            return decode_two_phase(lambda y: cuda_launch.launch(plans[FAST], y, t), single,
                                    x, cap)

        sweep[t] = {
            "exact": (same(single(llr5), want[5]) and same(single(llr2), want[2])
                      and same(triage(llr5), want[5])),
            "single_5dB": timed(lambda: single(llr5))["median"],
            "triage_5dB": timed(lambda: triage(llr5))["median"],
            "single_2dB": timed(lambda: single(llr2))["median"],
        }
    out["tile_sweep_ms"] = sweep
    return out


if __name__ == "__main__":
    raise SystemExit(main())
