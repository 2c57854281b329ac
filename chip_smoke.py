#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: print the ``nvidia-smi`` name and power limit; require CUDA.
2. Build: compile both kernels (csrc/bp_layered.cu, csrc/bp_long.cu), one
   nvcc per source started together, and print each build time.
3. Short-code kernel vs plain: the kernel on CUDA against its plain version
   (``decode_qc_cuda_plain``) on the CPU and on CUDA, at batch 1000 (a
   ragged tail) for all six 802.16e rates at n=576 plus n=2304 rate 1/2,
   5 and 2 dB, alpha 0.75 and a per-layer alpha tuple, early exit on and
   off.  Bits, converged, iterations and total_iters must be equal.
3b. Long-code kernel vs plain: the kernel against ``decode_qc_long_plain``
   on CUDA (batch 101) and on the CPU (batch 16), for nr_code(384, 1),
   nr_code(384, 2) and nr_code(208, 1), rate-matched rv0 LLRs at an SNR
   where nearly every frame converges and one where most run 30
   iterations, alpha 0.8 and a per-layer alpha tuple, early exit on and
   off; and at the main path's batch of 512 on nr_code(384, 1), past one
   wave of resident blocks, the hard SNR with early exit off.  The same
   four fields must be equal.
3c. The same kernel on DVB-S2 (multi-edge cells, the masked wrap row) and
   in its global-posterior mode (kernel D's port), against its plain
   version (the lazy-aware one in lazy mode) on CUDA and, for 16200, on
   the CPU at batch 16: dvbs2(16200, "1/2") and dvbs2(16200, "8/9") (rows
   of 35 circulants) in shared memory, dvbs2(64800, "1/2") and
   dvbs2(64800, "3/4") in global memory, at an SNR where nearly every
   frame converges and one where most run 30 iterations, exact and lazy,
   alpha 0.85 and per layer, early exit on and off; dvbs2(64800, "9/10")
   (rows of 40) once; a plain staircase QC code whose posterior passes
   shared memory (kernel D's own domain), on all-zero-codeword LLRs from
   hopeless to easy; the global mode forced on
   nr_code(384, 1) and dvbs2(16200, "1/2"), equal to the shared mode; and
   the main path's batch of 1024, lazy, early exit off.
4. Short-code main path: ``Decoder(wimax(576, "3/4B"), bench config,
   device="cuda")`` at batch 8192, 5 dB, noise from a torch.Generator on
   the card; then the ``Coder`` TDMPCL byte-stream round trip of the CLI
   ``test`` flow, held against the CPU TDMP decode of the same soft stream.
4b. NR main path (BASELINE config 4): nr_code(384, 1) encoded on the card,
   rate-matched rv0 over the full buffer, BPSK/AWGN at 3, 4, 5 and 6 dB,
   de-rate-matched and decoded by ``Decoder(..., device="cuda")`` (layered
   NMS alpha 0.8, 30 iterations, batch 512), which must resolve to
   ``cuda_long``; bench.py's gates at each point, and the torch path on
   the same LLRs at 5 dB.  Then the CLI ``waterfall --family nr --z 384
   --bg 1`` for two SNR points, and again from its checkpoint, which must
   run no new step.
4c. DVB-S2 main path (BASELINE config 3): dvbs2(64800, "1/2") encoded on
   the card (``ira_encode_fn``), BPSK/AWGN at 1.0 and 1.4 dB, decoded by
   ``Decoder(..., device="cuda")`` (layered NMS alpha 0.85, 30 iterations,
   lazy syndrome, batch 1024), which must resolve to ``cuda_long`` with the
   posterior in global memory; bench.py's gates at 1.4 dB; equal to the
   lazy plain version, and within the lazy contract of the exact torch
   path.  Then the CLI ``waterfall --family dvbs2 --n 16200 --rate 1/2``
   for two SNR points, and again from its checkpoint.
5. Times: CUDA events, median of 7 after a warm-up (3 for the plain
   version at DVB-S2 64800): each kernel and its plain version (single
   pass, no triage) and the whole Decoder call, at the main paths' shapes,
   DVB-S2 64800 in lazy and exact mode; and the kernel on dvbs2(16200,
   "1/2") at batch 1024, its posterior in shared and in global memory.

The line before the last is the kernels' JSON record: each kernel's
``launches`` counts its launches in its main path's ``Decoder`` call (and
``coder_launches`` those of the Coder TDMPCL decode), each counter set to 0
just before its run; ``bound_ms`` is the least time the card could take
for the same work (:func:`bound`).  The last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from myldpccppapi_torch import (
    Coder,
    Decoder,
    DecoderConfig,
    Encoder,
    QCCode,
    cli,
    dvbs2,
    nr_code,
    wimax,
)
from myldpccppapi_torch.codes import (
    encode_numpy,
    ira_encode_fn,
    ira_encode_numpy,
    rate_match_bits,
    rate_match_llr,
    ru_precompute,
    triangular_encode_fn,
    triangular_encode_numpy,
)
from myldpccppapi_torch.ops import _build
from myldpccppapi_torch.ops.channel import transmit
from myldpccppapi_torch.ops.cuda_bp import (
    decode_qc_cuda,
    decode_qc_cuda_plain,
    tile_size,
)
from myldpccppapi_torch.ops.cuda_long import (
    GLOBAL,
    SHARED,
    decode_qc_long,
    decode_qc_long_plain,
    placement,
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
#: BASELINE config 4 (benchmarks/run_baseline.py config4): layered NMS
#: alpha 0.8, 30 iterations, batch 512, 3-6 dB
NR_CFG = DecoderConfig(normalization=0.8, max_iters=30)
NR_BATCH = 512
NR_SNRS = (3.0, 4.0, 5.0, 6.0)
#: kernel C cases: (z, bg, [an SNR where nearly every frame converges, one
#: where most frames run 30 iterations]) for rate-matched rv0 LLRs
NR_CASES = ((384, 1, (3.0, -1.25)), (384, 2, (3.0, -3.0)),
            (208, 1, (3.0, -1.25)))
#: BASELINE config 3 (benchmarks/run_baseline.py config3): DVB-S2 64800
#: r1/2, layered NMS alpha 0.85, 30 iterations, lazy syndrome, batch 1024
DVB_CFG = DecoderConfig(normalization=0.85, max_iters=30, syndrome_mode="lazy")
DVB_BATCH = 1024
DVB_SNRS = (1.0, 1.4)
#: kernel C/D DVB-S2 cases: (n, rate, placement, [an SNR where nearly every
#: frame converges, one where most frames run 30 iterations])
DVB_CASES = ((16200, "1/2", SHARED, (1.5, 0.0)), (16200, "8/9", SHARED, (6.5, 5.5)),
             (64800, "1/2", GLOBAL, (1.4, 1.0)), (64800, "3/4", GLOBAL, (4.2, 3.5)))
#: the card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s and f32
#: operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: f32 operations of the min-sum per edge and sweep: pass 1 forms q, |q|,
#: two mins and a max and compares the sign; pass 2 forms q again,
#: compares |q| with m1, selects the magnitude and the sign, and forms and
#: adds the delta
OPS_PER_EDGE_SWEEP = 12


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


def nr_numpy_llr(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """NR codewords of random info bits, rate-matched rv0 over the full
    buffer, through BPSK/AWGN (noise from numpy), de-rate-matched: [batch,
    n] float32 on the CPU with LLR 0 in the 2Z punctured columns."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    tx = triangular_encode_numpy(code, u)[:, code.punctured_front:]
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * tx.astype(np.float32) + sigma * rng.standard_normal(tx.shape).astype(np.float32)
    return rate_match_llr(code, torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32)))


def phase_long_kernel_vs_plain() -> float:
    worst = 0.0
    n_cases = 0
    for ci, (z, bg, snrs) in enumerate(NR_CASES):
        code = nr_code(z, bg)
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.7, 0.9, code.m_b), 3))
        for snr in snrs:
            llr_gpu = nr_numpy_llr(code, 101, snr, SEED + 100 + ci).cuda()
            llr_cpu = llr_gpu[:16].cpu()
            shown = None  # the alpha 0.8, early-exit case, for the log
            for alpha in (0.8, per_layer):
                for early_exit in (True, False):
                    cfg = DecoderConfig(normalization=alpha, max_iters=30,
                                        early_exit=early_exit)
                    k = decode_qc_long(code, cfg, llr_gpu)
                    k16 = decode_qc_long(code, cfg, llr_cpu.cuda())
                    torch.cuda.synchronize()
                    worst = max(worst,
                                max_abs_diff(k, decode_qc_long_plain(code, cfg, llr_gpu)),
                                max_abs_diff(k16, decode_qc_long_plain(code, cfg, llr_cpu)))
                    n_cases += 1
                    shown = shown or k
            at_max = (shown.iterations == 30).float().mean().item()
            log(f"[phase3b] {code.name} snr={snr} "
                f"conv={shown.converged.float().mean().item():.4f} "
                f"at_30_iters={at_max:.4f} total_iters={int(shown.total_iters)}: "
                "kernel == plain (cpu, cuda)")
    # the main path's batch spans more than one wave of resident blocks;
    # frames that run all 30 sweeps exercise every block's R slice there
    z, bg, (_, hard) = NR_CASES[0]
    code = nr_code(z, bg)
    cfg = DecoderConfig(normalization=0.8, max_iters=30, early_exit=False)
    llr = nr_numpy_llr(code, NR_BATCH, hard, SEED + 200).cuda()
    k = decode_qc_long(code, cfg, llr)
    torch.cuda.synchronize()
    worst = max(worst, max_abs_diff(k, decode_qc_long_plain(code, cfg, llr)))
    n_cases += 1
    log(f"[phase3b] {code.name} batch={NR_BATCH} snr={hard} early_exit=off "
        f"conv={k.converged.float().mean().item():.4f} "
        f"total_iters={int(k.total_iters)}: kernel == plain (cuda)")
    log(f"[phase3b] {n_cases} cases bit-exact")
    return worst


def dvbs2_llr(code, batch: int, snr_db: float, seed: int) -> torch.Tensor:
    """DVB-S2 codewords of random info bits (``ira_encode_numpy``) through
    BPSK/AWGN, noise from numpy: [batch, n] float32 on the CPU."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = ira_encode_numpy(code, u)
    sigma = np.float32(10 ** (-snr_db / 20))
    y = 1 - 2 * c.astype(np.float32) + sigma * rng.standard_normal(c.shape).astype(np.float32)
    return torch.from_numpy((y * np.float32(2 / sigma**2)).astype(np.float32))


def staircase_qc(z: int = 360, q: int = 54, kb: int = 108, seed: int = 7) -> QCCode:
    """The staircase QC code of the reference's tests/test_pallas.py
    (_staircase_qc: a p0 column and a dual-diagonal parity part, layers of
    unequal degree) at n_b = 162: its posterior, 233,280 B, passes a
    thread block's shared memory, so it is kernel D's own domain, a plain
    single-circulant code in the global placement."""
    rng = np.random.default_rng(seed)
    base = np.full((q, kb + q), -1, dtype=np.int32)
    for g in range(kb):
        deg = 8 if g < kb // 3 else 3
        for l in rng.choice(q, size=deg, replace=False):
            base[l, g] = int(rng.integers(0, z))
    base[0, kb] = 1
    base[q // 2, kb] = 0
    base[q - 1, kb] = 1
    for j in range(q - 1):
        base[j, kb + 1 + j] = 0
        base[j + 1, kb + 1 + j] = 0
    return QCCode(name=f"staircase_z{z}_q{q}", base=base, z=z)


def check_long(code, cfg, llr_gpu, llr_cpu=None, force_global=False):
    """The long-code kernel against its plain version on the same LLRs, on
    CUDA and (``llr_cpu``) on the CPU; returns the CUDA result and the
    largest difference (0.0: any other raises)."""
    k = decode_qc_long(code, cfg, llr_gpu, _force_global=force_global)
    torch.cuda.synchronize()
    worst = max_abs_diff(k, decode_qc_long_plain(code, cfg, llr_gpu))
    if llr_cpu is not None:
        k16 = decode_qc_long(code, cfg, llr_cpu.cuda(), _force_global=force_global)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_diff(k16, decode_qc_long_plain(code, cfg, llr_cpu)))
    return k, worst


def summary(res) -> str:
    return (f"conv={res.converged.float().mean().item():.4f} "
            f"at_30_iters={(res.iterations == 30).float().mean().item():.4f} "
            f"total_iters={int(res.total_iters)}")


def phase_dvbs2_kernel_vs_plain() -> tuple[float, float]:
    """Returns the largest differences of the shared and the global mode
    (0.0: any other raises)."""
    dev = torch.cuda.current_device()
    worst = {SHARED: 0.0, GLOBAL: 0.0}
    n_cases = 0
    for ci, (n, rate, where, snrs) in enumerate(DVB_CASES):
        code = dvbs2(n, rate)
        if placement(code, dev) != where:
            raise AssertionError(f"{code.name}: placement {placement(code, dev)}, "
                                 f"expected {where}")
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.75, 0.9, code.m_b), 3))
        batch = 101 if n == 16200 else 64
        for si, snr in enumerate(snrs):
            llr_cpu = dvbs2_llr(code, batch, snr, SEED + 300 + ci)
            llr_gpu = llr_cpu.cuda()
            cpu16 = llr_cpu[:16].contiguous() if n == 16200 else None
            # 64800: alpha scalar at the easy SNR, per layer at the hard one
            alphas = (0.85, per_layer) if n == 16200 else ((0.85, per_layer)[si],)
            before = decode_qc_long.global_launches
            for mode in ("exact", "lazy"):
                for alpha in alphas:
                    for early_exit in (True, False):
                        cfg = DecoderConfig(normalization=alpha, max_iters=30,
                                            early_exit=early_exit,
                                            syndrome_mode=mode)
                        k, d = check_long(code, cfg, llr_gpu, cpu16)
                        worst[where] = max(worst[where], d)
                        n_cases += 1
                        if alpha == 0.85 and early_exit:
                            log(f"[phase3c] {code.name} "
                                f"{'shared' if where == SHARED else 'global'} "
                                f"snr={snr} {mode} {summary(k)}: kernel == plain"
                                + (" (cpu, cuda)" if cpu16 is not None else " (cuda)"))
            if (decode_qc_long.global_launches > before) != (where == GLOBAL):
                raise AssertionError(f"{code.name} ran in the wrong placement")
    # rows of 40 circulants, in global memory
    code = dvbs2(64800, "9/10")
    cfg = DecoderConfig(normalization=tuple(np.round(np.linspace(0.75, 0.9, code.m_b), 3)),
                        max_iters=30, syndrome_mode="lazy")
    k, d = check_long(code, cfg, dvbs2_llr(code, 64, 6.5, SEED + 310).cuda())
    worst[GLOBAL] = max(worst[GLOBAL], d)
    n_cases += 1
    log(f"[phase3c] {code.name} (widest row {code.max_row_degree}) global "
        f"snr=6.5 lazy per-layer {summary(k)}: kernel == plain (cuda)")
    # kernel D's own domain: a plain QC code past shared memory
    code = staircase_qc()
    if placement(code, dev) != GLOBAL:
        raise AssertionError(f"{code.name} is not in the global placement")
    # consistent Gaussian LLRs of the all-zero codeword, mean m and variance
    # 2m, m spread over the batch from hopeless to easy
    rng = np.random.default_rng(SEED + 320)
    m = np.linspace(1.0, 8.0, 64, dtype=np.float32)[:, None]
    llr = torch.from_numpy((m + np.sqrt(2 * m) * rng.standard_normal(
        (64, code.n))).astype(np.float32)).cuda()
    for mode in ("exact", "lazy"):
        for early_exit in (True, False):
            cfg = DecoderConfig(normalization=0.8, max_iters=30,
                                early_exit=early_exit, syndrome_mode=mode)
            k, d = check_long(code, cfg, llr)
            worst[GLOBAL] = max(worst[GLOBAL], d)
            n_cases += 1
        log(f"[phase3c] {code.name} n={code.n} global {mode} {summary(k)}: "
            "kernel == plain (cuda)")
    # the global mode forced where shared memory would hold the posterior
    forced = ((nr_code(384, 1), DecoderConfig(normalization=0.8, max_iters=30),
               lambda snr, seed: nr_numpy_llr(nr_code(384, 1), 64, snr, seed),
               (3.0, -1.25)),
              (dvbs2(16200, "1/2"), DVB_CFG,
               lambda snr, seed: dvbs2_llr(dvbs2(16200, "1/2"), 64, snr, seed),
               (1.5, 0.0)))
    for fi, (code, base_cfg, make, snrs) in enumerate(forced):
        for snr in snrs:
            llr = make(snr, SEED + 330 + fi).cuda()
            for mode in ("exact", "lazy"):
                cfg = dataclasses.replace(base_cfg, syndrome_mode=mode)
                k, d = check_long(code, cfg, llr, force_global=True)
                worst[GLOBAL] = max(worst[GLOBAL], d,
                                    max_abs_diff(k, decode_qc_long(code, cfg, llr)))
                n_cases += 1
            log(f"[phase3c] {code.name} forced global snr={snr} {summary(k)}: "
                "kernel (global) == kernel (shared) == plain (cuda)")
    # the main path's batch, every block running all 30 sweeps
    code = dvbs2(64800, "1/2")
    cfg = dataclasses.replace(DVB_CFG, early_exit=False)
    k, d = check_long(code, cfg, dvbs2_llr(code, DVB_BATCH, 1.4, SEED + 340).cuda())
    worst[GLOBAL] = max(worst[GLOBAL], d)
    n_cases += 1
    log(f"[phase3c] {code.name} batch={DVB_BATCH} snr=1.4 lazy early_exit=off "
        f"{summary(k)}: kernel == plain (cuda)")
    log(f"[phase3c] {n_cases} cases bit-exact")
    return worst[SHARED], worst[GLOBAL]


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
    log(f"[phase4] Decoder impl={dec.implementation} batch={BATCH} "
        f"snr={SNR_DB} {gates(dec, res, u)} launches={decoder_launches}")
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


def gates(dec, res, u) -> str:
    """bench.py's sanity gates on one decoded batch: convergence > 0.98,
    bit errors <= unconverged frames x k, and converged frames with a zero
    syndrome.  Returns the batch's summary."""
    code = dec.code
    conv = res.converged.float().mean().item()
    unconv = int((~res.converged).sum())
    berr = int((dec.info_bits(res) != u).sum())
    if not conv > 0.98:
        raise AssertionError(f"convergence {conv} <= 0.98")
    if berr > unconv * code.k:
        raise AssertionError(f"{berr} bit errors > {unconv} unconverged x k")
    bits = res.bits.cpu().numpy()
    if code.syndrome(bits[res.converged.cpu().numpy()]).any():
        raise AssertionError("a converged frame has a nonzero syndrome")
    return (f"conv={conv:.4f} mean_iters={res.iterations.float().mean().item():.3f} "
            f"total_iters={int(res.total_iters)} bit_errors={berr}")


def phase_nr_main_path():
    code = nr_code(384, 1)
    dec = Decoder(code, NR_CFG, device="cuda")
    if dec.implementation != "cuda_long":
        raise AssertionError(f"NR main path resolved to {dec.implementation}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    u = torch.randint(0, 2, (NR_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    e = code.n - code.punctured_front  # rv0 over the full buffer
    tx = rate_match_bits(code, triangular_encode_fn(code)(u), e)
    llrs = {}
    for snr in NR_SNRS:
        llr_e, _ = transmit(gen, tx, snr)
        llrs[snr] = rate_match_llr(code, llr_e, e).contiguous()
    torch.cuda.synchronize()

    decode_qc_long.launches = 0
    results = {snr: dec(llr) for snr, llr in llrs.items()}
    torch.cuda.synchronize()
    launches = decode_qc_long.launches
    if launches < 1:
        raise AssertionError("the NR Decoder launched no long-code kernel")
    for snr, res in results.items():
        log(f"[phase4b] Decoder impl={dec.implementation} {code.name} "
            f"batch={NR_BATCH} snr={snr} {gates(dec, res, u)}")
    log(f"[phase4b] launches={launches}")
    plain = Decoder(code, NR_CFG, device="cuda", implementation="torch")
    max_abs_diff(results[5.0], plain(llrs[5.0]))
    log("[phase4b] Decoder(cuda_long) == Decoder(torch) on the same LLRs at 5 dB")
    # a code neither kernel serves (z < 64, 310 circulants) is refused on
    # the card: there is no quiet torch path there
    small = nr_code(48, 1)
    try:
        Decoder(small, NR_CFG, device="cuda")
    except ValueError as e:
        log(f"[phase4b] Decoder({small.name}, device=cuda) refused: "
            f"{str(e)[:60]}...")
    else:
        raise AssertionError(f"Decoder({small.name}) on the card did not raise")

    waterfall_and_resume("phase4b", ["--family", "nr", "--z", "384", "--bg", "1",
                                     "--snr=-2.5,-1.5", "--normalization", "0.8"])
    return dec, llrs[5.0], launches


def waterfall_and_resume(tag: str, code_args: list) -> None:
    """The CLI ``waterfall`` on the card for two SNR points (batch 256, up
    to 512 frames, 30 iterations), then again from its checkpoint, which
    must run no new step and print the same lines.  The code must be one
    the long-code kernel serves in shared memory."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.json")
        argv = ["waterfall", *code_args, "--batch", "256", "--target-errors",
                "20", "--max-frames", "512", "--max-iters", "30",
                "--checkpoint", ck, "--out", os.path.join(tmp, "wf.csv"),
                "--device", "cuda"]
        runs = []
        for _ in range(2):
            decode_qc_long.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise AssertionError("waterfall exited non-zero")
            with open(ck) as f:
                steps = json.load(f)["steps_done"]
            runs.append((buf.getvalue().strip().splitlines(),
                         decode_qc_long.launches, steps))
        (lines, first_launches, steps), (lines2, resumed_launches, steps2) = runs
        for line in lines:
            log(f"[{tag}] waterfall {line}")
        if first_launches < 1:
            raise AssertionError("the waterfall launched no long-code kernel")
        if resumed_launches != 0 or steps2 != steps or lines2 != lines:
            raise AssertionError(
                f"the resumed waterfall ran new steps ({resumed_launches} "
                f"launches, steps {steps} -> {steps2})")
        log(f"[{tag}] waterfall: {sum(steps)} steps, {first_launches} "
            "launches; rerun from its checkpoint: 0 new steps, same lines")


def phase_dvbs2_main_path():
    code = dvbs2(64800, "1/2")
    dec = Decoder(code, DVB_CFG, device="cuda")
    where = placement(code, torch.cuda.current_device())
    if dec.implementation != "cuda_long" or where != GLOBAL:
        raise AssertionError(f"DVB-S2 main path resolved to {dec.implementation} "
                             f"in placement {where}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    cw = ira_encode_fn(code)(u)
    if code.syndrome(cw[:64].cpu().numpy()).any():
        raise AssertionError("ira_encode_fn made a non-codeword")
    llrs = {snr: transmit(gen, cw, snr)[0].contiguous() for snr in DVB_SNRS}
    torch.cuda.synchronize()

    decode_qc_long.launches = 0
    decode_qc_long.global_launches = 0
    results = {snr: dec(llr) for snr, llr in llrs.items()}
    torch.cuda.synchronize()
    launches, shared = decode_qc_long.global_launches, decode_qc_long.launches
    if launches < 1 or shared:
        raise AssertionError(f"the DVB-S2 Decoder launched the global mode "
                             f"{launches} times and the shared one {shared}")
    for snr, res in results.items():
        state = gates(dec, res, u) if snr == 1.4 else summary(res)
        log(f"[phase4c] Decoder impl={dec.implementation} (posterior in global "
            f"memory) {code.name} batch={DVB_BATCH} snr={snr} lazy {state}")
    log(f"[phase4c] launches={launches} (global mode)")
    for snr, llr in llrs.items():
        max_abs_diff(results[snr], decode_qc_long_plain(code, DVB_CFG, llr))
    log("[phase4c] Decoder(cuda_long) == the lazy plain version at 1.0 and 1.4 dB")
    # the lazy contract against the exact torch path: the same converged
    # frames and bits at a benign point, detection never earlier
    lazy = results[1.4]
    exact = Decoder(code, DVB_CFG, device="cuda", implementation="torch")(llrs[1.4])
    conv = lazy.converged
    if not (torch.equal(conv, exact.converged)
            and torch.equal(lazy.bits[conv], exact.bits[conv])):
        raise AssertionError("lazy and exact decodes differ at 1.4 dB")
    lag = (lazy.iterations - exact.iterations).float()
    if lag.min() < 0:
        raise AssertionError("a lazy decode latched before the exact one")
    log(f"[phase4c] lazy vs Decoder(torch) (exact syndrome) at 1.4 dB: same "
        f"converged frames and bits; lazy - exact iterations: mean "
        f"{lag.mean().item():.3f}, min {int(lag.min())}, max {int(lag.max())}")
    waterfall_and_resume("phase4c", ["--family", "dvbs2", "--n", "16200", "--rate",
                                     "1/2", "--snr=0.5,1.0", "--normalization", "0.85"])
    return dec, llrs[1.4], launches


def bound(code, cfg, llr, res) -> tuple[float, str]:
    """The least time the card could take for one decode of ``llr``: the
    larger of its bytes (each LLR read once, each output -- bits, converged,
    iterations -- written once) over the HBM rate and its f32 operations
    (OPS_PER_EDGE_SWEEP per Tanner-graph edge and sweep, over the sweeps
    this run's frames ran: ``iterations`` each with early exit, else every
    sweep) over the f32 rate.  Returns (ms, "bytes" or "operations")."""
    batch = llr.shape[0]
    nbytes = batch * code.n * (4 + 1) + batch * (1 + 4)
    sweeps = (int(res.iterations.sum()) if cfg.early_exit
              else batch * cfg.max_iters)
    ops = sweeps * code.num_edges * OPS_PER_EDGE_SWEEP
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def phase_times(dec, llr, kernel, plain, cfg, plain_reps: int = 7, tag: str = ""):
    code = dec.code
    out = {
        "kernel": median_ms(lambda: kernel(code, cfg, llr)),
        "plain": median_ms(lambda: plain(code, cfg, llr), plain_reps),
        "decoder": median_ms(lambda: dec(llr)),
    }
    out["bound"], out["bound_by"] = bound(code, cfg, llr, kernel(code, cfg, llr))
    for name in ("kernel", "plain", "decoder", "bound"):
        ms = out[name]
        mbits = llr.shape[0] * code.k / (ms * 1e-3) / 1e6
        log(f"[phase5] {code.name}{tag} {name}: {ms:.4f} ms per batch of "
            f"{llr.shape[0]} = {mbits:.1f} Mbit/s decoded info"
            + (f" (bound by {out['bound_by']})" if name == "bound" else ""))
    return out


def phase_dvbs2_times(dvb_dec, dvb_llr):
    """The DVB-S2 64800 main path in lazy and exact mode; then the kernel
    on dvbs2(16200, "1/2") at the same batch, posterior in shared and in
    global memory."""
    times = {}
    for mode in ("lazy", "exact"):
        cfg = dataclasses.replace(DVB_CFG, syndrome_mode=mode)
        dec = dvb_dec if mode == "lazy" else Decoder(dvb_dec.code, cfg, device="cuda")
        times[mode] = phase_times(dec, dvb_llr, decode_qc_long,
                                  decode_qc_long_plain, cfg, plain_reps=3,
                                  tag=f" {mode}")
    code = dvbs2(16200, "1/2")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    u = torch.randint(0, 2, (DVB_BATCH, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    llr = transmit(gen, ira_encode_fn(code)(u), 1.5)[0].contiguous()
    for force in (False, True):
        ms = median_ms(lambda: decode_qc_long(code, DVB_CFG, llr, _force_global=force))
        res = decode_qc_long(code, DVB_CFG, llr, _force_global=force)
        log(f"[phase5] {code.name} lazy kernel, posterior in "
            f"{'global' if force else 'shared'} memory: {ms:.4f} ms per batch of "
            f"{DVB_BATCH} at 1.5 dB ({summary(res)}, mean iterations "
            f"{res.iterations.float().mean().item():.3f})")
    return times


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

    lib_path, seconds = _build.build()
    for step, s in seconds.items():
        log(f"[phase2] built {step} in {s:.2f} s")
    _build.load()
    log(f"[phase2] loaded {lib_path.name}")

    worst = phase_kernel_vs_plain()
    worst_long = phase_long_kernel_vs_plain()
    worst_shared, worst_global = phase_dvbs2_kernel_vs_plain()
    dec, llr, launches, coder_launches = phase_main_path()
    nr_dec, nr_llr, nr_launches = phase_nr_main_path()
    dvb_dec, dvb_llr, dvb_launches = phase_dvbs2_main_path()
    times = phase_times(dec, llr, decode_qc_cuda, decode_qc_cuda_plain,
                        dataclasses.replace(BENCH_CFG, triage_iters=0))
    nr_times = phase_times(nr_dec, nr_llr, decode_qc_long,
                           decode_qc_long_plain, NR_CFG)
    dvb_times = phase_dvbs2_times(dvb_dec, dvb_llr)["lazy"]

    log(smi)

    def entry(name, source, replaces, launches, worst, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"myldpccppapi_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": worst, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"],
                # no single PyTorch call computes a BP decode
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("bp_layered", "bp_layered.cu", "myldpccppapi_tpu/ops/pallas_bp.py:249",
              launches, worst, times, coder_launches=coder_launches),
        entry("bp_long", "bp_long.cu", "myldpccppapi_tpu/ops/pallas_zlane.py:205",
              nr_launches, max(worst_long, worst_shared), nr_times),
        # the same source's global-posterior mode
        entry("bp_long_global", "bp_long.cu",
              "myldpccppapi_tpu/ops/pallas_stream.py:120", dvb_launches,
              worst_global, dvb_times),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
