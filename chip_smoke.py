#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: print the ``nvidia-smi`` name and power limit; require CUDA.
2. Build: compile the layered BP kernel (csrc/bp_layered.cu) with nvcc.
3. Kernel vs plain: the kernel on CUDA against its plain version
   (``decode_qc_cuda_plain``) on the CPU and on CUDA, at batch 1000 (a
   ragged tail) for all six 802.16e rates at n=576 plus n=2304 rate 1/2,
   5 and 2 dB, alpha 0.75 and a per-layer alpha tuple, early exit on and
   off.  Bits, converged, iterations and total_iters must be equal.
4. Main path: ``Decoder(wimax(576, "3/4B"), bench config, device="cuda")``
   at batch 8192, 5 dB, noise from a torch.Generator on the card; then the
   ``Coder`` TDMPCL byte-stream round trip of the CLI ``test`` flow, held
   against the CPU TDMP decode of the same soft stream.
5. Times: CUDA events, median of 7 after a warm-up: the kernel and the
   plain version (single pass, no triage) and the whole Decoder call.

The line before the last is the kernels' JSON record: ``launches`` counts
the kernel launches of the main-path ``Decoder`` call, ``coder_launches``
those of the Coder TDMPCL decode, each counter set to 0 just before its
run.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from myldpccppapi_torch import Coder, Decoder, DecoderConfig, Encoder, wimax
from myldpccppapi_torch.codes import encode_numpy, ru_precompute
from myldpccppapi_torch.ops import _build
from myldpccppapi_torch.ops.channel import transmit
from myldpccppapi_torch.ops.cuda_bp import (
    decode_qc_cuda,
    decode_qc_cuda_plain,
    tile_size,
)
from myldpccppapi_torch.ops.packing import unpack_bits_np

SEED = 20260816
BATCH = 8192
SNR_DB = 5.0
#: bench.py's operating point: layered NMS, alpha 0.75, 40 iterations,
#: two-phase triage with a 5-iteration fast pass
BENCH_CFG = DecoderConfig(algorithm="min-sum", schedule="layered",
                          normalization=0.75, max_iters=40, triage_iters=5)
RATES_576 = ("1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6")
FIELDS = ("bits", "converged", "iterations", "total_iters")


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_diff(a, b) -> float:
    """Max |a - b| over the DecodeResult fields; raises unless 0."""
    worst = 0.0
    for f in FIELDS:
        x = getattr(a, f).cpu().to(torch.int64)
        y = getattr(b, f).cpu().to(torch.int64)
        if x.shape != y.shape:
            raise AssertionError(f"{f}: shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = float((x - y).abs().max()) if x.numel() else 0.0
        if d != 0.0:
            raise AssertionError(f"{f} differs (max abs {d})")
        worst = max(worst, d)
    return worst


def numpy_llr(code, batch: int, snr_db: float, seed: int) -> np.ndarray:
    """Codewords of random info bits through BPSK/AWGN, noise from numpy."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(ru_precompute(code), u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return (y * np.float32(2 / sigma**2)).astype(np.float32)


def phase_kernel_vs_plain() -> float:
    dev = torch.cuda.current_device()
    codes = [wimax(576, r) for r in RATES_576] + [wimax(2304, "1/2")]
    worst = 0.0
    n_cases = 0
    for ci, code in enumerate(codes):
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.65, 0.85, code.m_b), 3))
        for snr in (5.0, 2.0):
            llr = numpy_llr(code, 1000, snr, SEED + ci)
            llr_cpu = torch.from_numpy(llr)
            llr_gpu = llr_cpu.cuda()
            for alpha in (0.75, per_layer):
                for early_exit in (True, False):
                    cfg = DecoderConfig(normalization=alpha, max_iters=40,
                                        early_exit=early_exit)
                    k = decode_qc_cuda(code, cfg, llr_gpu)
                    torch.cuda.synchronize()
                    worst = max(worst,
                                max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)),
                                max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_cpu)))
                    n_cases += 1
            log(f"[phase3] {code.name} tile={tile_size(code, dev)} "
                f"tail={1000 % tile_size(code, dev)} snr={snr} "
                f"conv={k.converged.float().mean().item():.4f} "
                f"total_iters={int(k.total_iters)}: kernel == plain (cpu, cuda)")
    log(f"[phase3] {n_cases} cases bit-exact")
    return worst


def phase_main_path():
    code = wimax(576, "3/4B")
    dec = Decoder(code, BENCH_CFG, device="cuda")
    if dec.implementation != "cuda":
        raise AssertionError(f"main path resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u = torch.randint(0, 2, (BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr, _ = transmit(gen, Encoder(code, device="cuda")(u), SNR_DB)
    torch.cuda.synchronize()

    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    decoder_launches = decode_qc_cuda.launches
    if decoder_launches < 2:
        raise AssertionError(f"expected a fast and a straggler launch, got "
                             f"{decoder_launches}")
    conv = res.converged.float().mean().item()
    unconv = int((~res.converged).sum())
    berr = int((dec.info_bits(res) != u).sum())
    log(f"[phase4] Decoder impl={dec.implementation} batch={BATCH} "
        f"snr={SNR_DB} conv={conv:.4f} mean_iters="
        f"{res.iterations.float().mean().item():.3f} total_iters="
        f"{int(res.total_iters)} bit_errors={berr} launches={decoder_launches}")
    # bench.py's sanity gates
    if not conv > 0.98:
        raise AssertionError(f"convergence {conv} <= 0.98")
    if berr > unconv * code.k:
        raise AssertionError(f"{berr} bit errors > {unconv} unconverged x k")
    bits = res.bits.cpu().numpy()
    if code.syndrome(bits[res.converged.cpu().numpy()]).any():
        raise AssertionError("a converged frame has a nonzero syndrome")
    plain = Decoder(code, BENCH_CFG, device="cuda", implementation="torch")
    max_abs_diff(res, plain(llr))
    log("[phase4] Decoder(cuda) == Decoder(torch) on the same LLRs")

    # the CLI `test` flow: Coder byte stream, TDMPCL on the card
    src = bytes((ord("a") + i % 26) for i in range(432_000))
    coder = Coder(432, 576, "3/4B", device="cuda")
    coder.for_encoder()
    coder.for_decoder(BATCH)
    prior = coder.encode(src)
    cw = unpack_bits_np(prior).reshape(-1, code.n)
    if code.syndrome(cw).any():
        raise AssertionError("encoded stream holds a non-codeword")
    post = coder.test(prior, 10 ** (-SNR_DB / 20), seed=SEED)
    decode_qc_cuda.launches = 0
    out, stats = coder.decode(post, len(src), "TDMPCL", return_stats=True)
    torch.cuda.synchronize()
    coder_launches = decode_qc_cuda.launches
    if coder_launches < 1:
        raise AssertionError("the Coder TDMPCL decode launched no kernel")
    cpu = Coder(432, 576, "3/4B", device="cpu")
    cpu.for_decoder(BATCH)
    out_cpu, stats_cpu = cpu.decode(post, len(src), "TDMP", return_stats=True)
    if not (np.array_equal(out, out_cpu)
            and np.array_equal(stats["converged"], stats_cpu["converged"])
            and np.array_equal(stats["iterations"], stats_cpu["iterations"])):
        raise AssertionError("Coder TDMPCL (cuda) differs from TDMP (cpu)")
    err = int(np.sum(np.frombuffer(src, np.uint8) != out))
    log(f"[phase4] Coder TDMPCL round trip: {len(src)} bytes, "
        f"{len(cw)} codewords, mean_iters={stats['mean_iters']:.3f}, "
        f"ErrNum={err}, launches={coder_launches}; equal to the CPU TDMP "
        "decode")
    return dec, llr, decoder_launches, coder_launches


def median_ms(fn, reps: int = 7) -> float:
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
    return statistics.median(times)


def phase_times(dec, llr):
    code = dec.code
    single = dataclasses.replace(BENCH_CFG, triage_iters=0)
    out = {
        "kernel": median_ms(lambda: decode_qc_cuda(code, single, llr)),
        "plain": median_ms(lambda: decode_qc_cuda_plain(code, single, llr)),
        "decoder": median_ms(lambda: dec(llr)),
    }
    for name, ms in out.items():
        mbits = llr.shape[0] * code.k / (ms * 1e-3) / 1e6
        log(f"[phase5] {name}: {ms:.4f} ms per batch of {llr.shape[0]} "
            f"= {mbits:.1f} Mbit/s decoded info")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[phase1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul

    t0 = time.perf_counter()
    _build.load()
    log(f"[phase2] built csrc/bp_layered.cu in {time.perf_counter() - t0:.2f} s")

    worst = phase_kernel_vs_plain()
    dec, llr, launches, coder_launches = phase_main_path()
    times = phase_times(dec, llr)

    log(smi)
    print(json.dumps({"kernels": [{
        "name": "bp_layered",
        "route": "cuda",
        "source": "myldpccppapi_torch/csrc/bp_layered.cu",
        "replaces": "myldpccppapi_tpu/ops/pallas_bp.py:249",
        "launches": launches,
        "coder_launches": coder_launches,
        "max_abs_err": worst,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
