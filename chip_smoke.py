#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device: print the ``nvidia-smi`` name and power limit; require CUDA.
2. Build: compile both kernels (csrc/bp_layered.cu, csrc/bp_long.cu), one
   nvcc per source started together, and print each build time.
3. Short-code kernel vs plain: the kernel on CUDA against its plain
   version (``decode_qc_cuda_plain``) on the CPU and on CUDA, at batch 1000
   (a ragged tail) for all six 802.16e rates at n=576 plus n=2304 rate
   1/2, 5 and 2 dB, a per-layer alpha tuple, early exit on and off (alpha
   0.75 is phase 3d's "soft layered" case).  Bits, converged, iterations
   and total_iters must be equal.
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
3d. Kernel A's new modes vs plain: flooding min-sum (alpha 1.0, alpha 0.75,
   per-layer alpha, beta 0.25), SCMS, sum-product (flooding and layered)
   and soft output (min-sum layered and flooding, sum-product layered and
   flooding), at 5 and 2 dB, early exit on and off, on all six 802.16e
   rates at n=576 plus n=2304 rate 1/2: the kernel at batch 1000 (a ragged
   tail) against its plain version on CUDA, and at batch 16 against it on
   the CPU.  Bits, converged, iterations, total_iters and the posteriors of
   every frame must be equal, with one tolerance: torch's CPU exp/log1p are
   not its CUDA ones (the phase counts the phi inputs where they differ),
   so sum-product is held against the CPU only at 5 dB, to equal bits and
   converged flags and iterations within 1 (its CPU posteriors' largest
   difference is logged).  Against the plain version on CUDA, sum-product
   is held bit-exact like every other mode.
3e. Kernel B's route (the same kernel, table-driven, on 5G NR codes of more
   than 120 circulants with z < 64): nr_code(z, 1) for z in 16, 32, 56 and
   nr_code(z, 2) for z in 8, 40, rate-matched rv0 LLRs with LLR-0
   punctured columns, at an SNR where nearly every frame converges and one
   where most run 30 iterations, early exit on and off, against the plain
   version on CUDA (batch 101) and the CPU (batch 16); ``Decoder(...,
   device="cuda")`` must resolve to ``"cuda"`` there.  Then the route's main
   path: nr_code(32, 1) encoded on the card at batch 4096, 3 dB, through
   ``Decoder``, with bench.py's gates.
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
4d. Flooding main path: ``Decoder(wimax(576, "3/4B"), ..., device="cuda")``
   on phase 4's LLRs (batch 8192, 5 dB) with flooding NMS alpha 0.75, SCMS,
   flooding sum-product (on the 2y/sigma^2 LLRs) and layered soft output,
   40 iterations: each must resolve to ``"cuda"``, pass bench.py's gates and
   equal ``Decoder(..., implementation="torch")``.  Then the ``Coder`` MSCL
   and SCMS round trips of phase 4's byte stream, each equal to the CPU
   decode of the same soft stream; and the CLI ``waterfall --family wimax
   --schedule flooding --self-correction`` for two SNR points, and again
   from its checkpoint.
5. Times: CUDA events, median of 7 after a warm-up (3 for the plain
   version at DVB-S2 64800, of the new modes and of kernel B's route): each
   kernel and its plain version (single pass, no triage) and the whole
   Decoder call, at the main paths' shapes, DVB-S2 64800 in lazy and exact
   mode, kernel A's flooding, SCMS, sum-product and layered soft-output
   modes at phase 4d's shape, kernel B's route at nr_code(32, 1), batch
   4096, 3 dB; and the kernel on dvbs2(16200, "1/2") at batch 1024, its
   posterior in shared and in global memory.

The line before the last is the kernels' JSON record, one entry per kernel
and mode: each ``launches`` counts its launches in its main path's
``Decoder`` call (and ``coder_launches`` those of the Coder TDMPCL, MSCL or
SCMS decode), each counter set to 0 just before its run; ``bound_ms`` is
the least time the card could take for the same work (:func:`bound`); the
sum-product entry's ``cpu_posterior_max_abs_err`` is its largest posterior
difference against the plain version on the CPU (phase 3d).  The last line is ``{"ok": true,
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
import time

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
#: kernel A's new modes (phase 3d): name -> (kernels-line group, config
#: fields); "per-layer" gets one alpha per base row of each code
A_MODES = {
    "flooding alpha 1.0": ("flooding", dict(schedule="flooding")),
    "flooding alpha 0.75": ("flooding", dict(schedule="flooding", normalization=0.75)),
    "flooding per-layer": ("flooding", dict(schedule="flooding", normalization=None)),
    "flooding beta 0.25": ("flooding", dict(schedule="flooding", offset=0.25)),
    "scms": ("scms", dict(schedule="flooding", self_correction=True)),
    "sp flooding": ("sp", dict(schedule="flooding", algorithm="sum-product")),
    "sp soft flooding": ("sp", dict(schedule="flooding", algorithm="sum-product",
                                    soft_output=True)),
    "sp soft layered": ("sp", dict(algorithm="sum-product", soft_output=True)),
    "soft layered": ("soft", dict(normalization=0.75, soft_output=True)),
    "soft flooding": ("soft", dict(schedule="flooding", normalization=0.75,
                                   soft_output=True)),
}
#: phase 4d's main paths, on phase 4's code and LLRs; each names the
#: kernels-line group it gives launches and times to
MODE_CFGS = {
    "flooding": DecoderConfig(schedule="flooding", normalization=0.75, max_iters=40),
    "scms": DecoderConfig(schedule="flooding", self_correction=True, max_iters=40),
    "sp": DecoderConfig(schedule="flooding", algorithm="sum-product", max_iters=40),
    "soft": DecoderConfig(normalization=0.75, max_iters=40, soft_output=True),
}
#: kernel B's route (phase 3e): (z, bg) and, per base graph, an SNR where
#: nearly every frame converges and one where most run 30 iterations
B_CODES = ((16, 1), (32, 1), (56, 1), (8, 2), (40, 2))
B_SNRS = {1: (3.0, -1.25), 2: (3.0, -3.0)}
#: the route's main path and phase-5 shape
B_MAIN = (32, 1)
B_BATCH = 4096
B_SNR = 3.0
#: the card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s and f32
#: operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: the special-function units' rate (exp2, lg2): 16 results per clock and
#: SM on compute capability 9.0 (the CUDA C++ Programming Guide's
#: arithmetic-instruction throughput table) x 132 SMs x the H100 SXM's
#: 1.98 GHz boost clock
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
#: f32 operations per edge and sweep that the decode itself needs, by mode
#: (what a kernel recomputes, such as q in a second pass, is not counted):
#: layered min-sum: q, |q|, two mins and a max, the sign compare (6); the
#: compare of |q| with m1, the magnitude and sign selects, the delta and
#: its add to P (5);
#: flooding min-sum: the same 6, the two selects and the compare (3), one
#: add of the posterior rebuild (1);
#: SCMS: q is read, not formed: |q|, mins, max, sign (5), the compare and
#: selects (3), the rebuild add (1), and the next q: a subtraction, two
#: sign-bit reads and a select (4);
#: sum-product: q, |q| (2), phi(|q|) (3: two clamps and the subtraction of
#: its two log1pf; negations are free operand modifiers), its add to the
#: total and the sign compare (2), total - phi(|q|) and phi of that (4),
#: the sign select (1), plus the delta and its add (2, layered) or the
#: rebuild add (1, flooding).  Two phi per edge, each an expf and two
#: log1pf: six special-function results, OPS_SFU_PER_EDGE_SWEEP.
OPS_PER_EDGE_SWEEP = {"layered": 11, "flooding": 10, "scms": 13,
                      "sp layered": 14, "sp flooding": 13}
OPS_SFU_PER_EDGE_SWEEP = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_diff(a, b) -> float:
    """Max |a - b| over the DecodeResult fields, the posteriors too where
    either has them; raises unless 0."""
    worst = 0.0
    if (a.posteriors is None) != (b.posteriors is None):
        raise AssertionError("posteriors: only one side has them")
    if a.posteriors is not None:
        x, y = a.posteriors.cpu(), b.posteriors.cpu()
        if not torch.equal(x, y):
            raise AssertionError(f"posteriors differ (max abs "
                                 f"{float((x - y).abs().max())})")
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


def sp_cpu_diff(a, b) -> float:
    """Sum-product's tolerance against its plain version on the CPU, whose
    exp/log1p are not CUDA's: equal bits and converged flags, iterations
    within 1 (raises otherwise).  Returns the posteriors' max |a - b| (0.0
    without soft output)."""
    for f in ("bits", "converged"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"sum-product on the CPU: {f} differs")
    d_it = (a.iterations.cpu().to(torch.int64) - b.iterations.cpu()).abs().max()
    if int(d_it) > 1:
        raise AssertionError(f"sum-product on the CPU: iterations differ by {int(d_it)}")
    if a.posteriors is None:
        return 0.0
    return float((a.posteriors.cpu() - b.posteriors.cpu()).abs().max())


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
    """Phase 3: the per-layer alpha only; alpha 0.75 runs the same layered
    instantiation in phase 3d's "soft layered" case on every code, SNR and
    early-exit setting."""
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
            for early_exit in (True, False):
                cfg = DecoderConfig(normalization=per_layer, max_iters=40,
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


def phase_modes_vs_plain() -> tuple[dict, float]:
    """Phase 3d; returns the largest difference per kernels-line group
    against the plain version on CUDA (0.0: any other raises) and
    sum-product's largest posterior difference against it on the CPU."""
    dev = torch.cuda.current_device()
    # torch's phi inputs (x in [1e-7, 30]) where its CPU exp or log1p give
    # other f32 results than its CUDA ones
    x = torch.linspace(1e-7, 30.0, 1_000_001)
    ex = torch.exp(-x)
    n_exp = int((ex != torch.exp(-x.cuda()).cpu()).sum())
    ex_gpu = ex.cuda()
    n_log = int(((torch.log1p(ex) != torch.log1p(ex_gpu).cpu())
                 | (torch.log1p(-ex) != torch.log1p(-ex_gpu).cpu())).sum())
    log(f"[phase3d] torch exp(-x) cpu != cuda on {n_exp}, log1p(+-e) on "
        f"{n_log} of {x.numel()} phi inputs")
    codes = [wimax(576, r) for r in RATES_576] + [wimax(2304, "1/2")]
    worst = {group: 0.0 for group, _ in A_MODES.values()}
    sp_cpu_post = 0.0
    n_cases = 0
    erased = 0
    for ci, code in enumerate(codes):
        per_layer = tuple(float(x) for x in np.round(
            np.linspace(0.65, 0.85, code.m_b), 3))
        for snr in (5.0, 2.0):
            llr_cpu = torch.from_numpy(numpy_llr(code, 1000, snr, SEED + 400 + ci))
            llr_gpu = llr_cpu.cuda()
            cpu16 = llr_cpu[:16].contiguous()
            shown = {}
            for name, (group, kw) in A_MODES.items():
                if kw.get("normalization", 1.0) is None:
                    kw = dict(kw, normalization=per_layer)
                for early_exit in (True, False):
                    cfg = DecoderConfig(max_iters=40, early_exit=early_exit, **kw)
                    k = decode_qc_cuda(code, cfg, llr_gpu)
                    worst[group] = max(
                        worst[group],
                        max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)))
                    if group != "sp":
                        worst[group] = max(worst[group], max_abs_diff(
                            decode_qc_cuda(code, cfg, cpu16.cuda()),
                            decode_qc_cuda_plain(code, cfg, cpu16)))
                    elif snr == 5.0:
                        sp_cpu_post = max(sp_cpu_post, sp_cpu_diff(
                            decode_qc_cuda(code, cfg, cpu16.cuda()),
                            decode_qc_cuda_plain(code, cfg, cpu16)))
                    n_cases += 1
                    if early_exit:
                        shown[name] = k
            # SCMS erases: its frames run otherwise than plain flooding's
            diff = int((shown["scms"].iterations
                        != shown["flooding alpha 1.0"].iterations).sum())
            erased += diff
            log(f"[phase3d] {code.name} snr={snr} tiles "
                + "/".join(str(tile_size(code, dev, m)) for m in (1, 5, 2))
                + " (flooding/scms/sp) conv "
                + " ".join(f"{n.split()[0]}={shown[n].converged.float().mean().item():.3f}"
                           for n in ("flooding alpha 0.75", "scms", "sp flooding"))
                + f" scms!=flooding on {diff} frames: "
                f"{2 * len(A_MODES)} cases kernel == plain (cuda; cpu, "
                + ("sum-product within its tolerance)" if snr == 5.0
                   else "min-sum only)"))
    if erased == 0:
        raise AssertionError("SCMS never ran otherwise than plain flooding")
    log(f"[phase3d] {n_cases} cases bit-exact against the plain version on "
        "CUDA (posteriors of every frame included; sum-product too); against "
        "the CPU every min-sum case bit-exact, sum-product at 5 dB with equal "
        "bits and converged flags, iterations within 1 (largest posterior "
        f"difference {sp_cpu_post})")
    return worst, sp_cpu_post


def phase_route_b_vs_plain():
    """Phase 3e; returns the largest difference (0.0: any other raises),
    the route's main-path Decoder, its LLRs and its launches."""
    worst = 0.0
    n_cases = 0
    for ci, (z, bg) in enumerate(B_CODES):
        code = nr_code(z, bg)
        impl = Decoder(code, NR_CFG, device="cuda").implementation
        if impl != "cuda" or code.num_blocks <= 120:
            raise AssertionError(f"{code.name}: resolved to {impl}")
        for snr in B_SNRS[bg]:
            llr_gpu = nr_numpy_llr(code, 101, snr, SEED + 500 + ci).cuda()
            llr_cpu = llr_gpu[:16].cpu()
            for early_exit in (True, False):
                cfg = DecoderConfig(normalization=0.8, max_iters=30,
                                    early_exit=early_exit)
                k = decode_qc_cuda(code, cfg, llr_gpu)
                k16 = decode_qc_cuda(code, cfg, llr_cpu.cuda())
                torch.cuda.synchronize()
                worst = max(worst,
                            max_abs_diff(k, decode_qc_cuda_plain(code, cfg, llr_gpu)),
                            max_abs_diff(k16, decode_qc_cuda_plain(code, cfg, llr_cpu)))
                n_cases += 1
                if early_exit:
                    shown = k
            log(f"[phase3e] {code.name} ({code.num_blocks} circulants) impl=cuda "
                f"tile={tile_size(code, torch.cuda.current_device())} snr={snr} "
                f"{summary(shown)}: kernel == plain (cpu, cuda)")
    log(f"[phase3e] {n_cases} cases bit-exact")
    code = nr_code(*B_MAIN)
    dec = Decoder(code, NR_CFG, device="cuda")
    u, llr = nr_card_llr(code, B_BATCH, (B_SNR,), SEED + 510)
    llr = llr[B_SNR]
    decode_qc_cuda.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    launches = decode_qc_cuda.launches
    if launches < 1:
        raise AssertionError("kernel B's route launched no kernel")
    log(f"[phase3e] Decoder impl={dec.implementation} {code.name} batch={B_BATCH} "
        f"snr={B_SNR} {gates(dec, res, u)} launches={launches}")
    return worst, dec, llr, launches


def nr_card_llr(code, batch: int, snrs, seed: int):
    """NR codewords of random info bits encoded on the card, rate-matched
    rv0 over the full buffer, through BPSK/AWGN at each SNR and
    de-rate-matched: (info bits, {snr: [batch, n] LLRs})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, 2, (batch, code.k), generator=gen, device="cuda",
                      dtype=torch.uint8)
    e = code.n - code.punctured_front  # rv0 over the full buffer
    tx = rate_match_bits(code, triangular_encode_fn(code)(u), e)
    llrs = {}
    for snr in snrs:
        llr_e, _ = transmit(gen, tx, snr)
        llrs[snr] = rate_match_llr(code, llr_e, e).contiguous()
    torch.cuda.synchronize()
    return u, llrs


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
    return dec, llr, u, decoder_launches, coder_launches, (coder, src, post)


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


def phase_flooding_main_path(llr, u, stream):
    """Phase 4d on phase 4's LLRs and byte stream; returns the Decoders by
    kernels-line group, their launches, and the Coder MSCL / SCMS
    launches."""
    code = wimax(576, "3/4B")
    decs, launches = {}, {}
    for group, cfg in MODE_CFGS.items():
        dec = Decoder(code, cfg, device="cuda")
        if dec.implementation != "cuda":
            raise AssertionError(f"{group} main path resolved to {dec.implementation}")
        decode_qc_cuda.launches = 0
        res = dec(llr)
        torch.cuda.synchronize()
        launches[group] = decode_qc_cuda.launches
        if launches[group] < 1:
            raise AssertionError(f"the {group} Decoder launched no kernel")
        max_abs_diff(res, Decoder(code, cfg, device="cuda", implementation="torch")(llr))
        decs[group] = dec
        log(f"[phase4d] Decoder {group} impl={dec.implementation} batch={BATCH} "
            f"snr={SNR_DB} {gates(dec, res, u)} launches={launches[group]}; "
            "== Decoder(torch)")
    coder, src, post = stream
    coder_launches = {}
    for de_type in ("MSCL", "SCMS"):
        decode_qc_cuda.launches = 0
        out, stats = coder.decode(post, len(src), de_type, return_stats=True)
        torch.cuda.synchronize()
        coder_launches[de_type] = decode_qc_cuda.launches
        if coder_launches[de_type] < 1:
            raise AssertionError(f"the Coder {de_type} decode launched no kernel")
        cpu = Coder(432, 576, "3/4B", device="cpu")
        cpu.for_decoder(BATCH)
        out_cpu, stats_cpu = cpu.decode(post, len(src), de_type, return_stats=True)
        if not (np.array_equal(out, out_cpu)
                and np.array_equal(stats["converged"], stats_cpu["converged"])
                and np.array_equal(stats["iterations"], stats_cpu["iterations"])):
            raise AssertionError(f"Coder {de_type} (cuda) differs from the CPU decode")
        err = int(np.sum(np.frombuffer(src, np.uint8) != out))
        log(f"[phase4d] Coder {de_type} round trip: {len(src)} bytes, "
            f"mean_iters={stats['mean_iters']:.3f}, ErrNum={err}, "
            f"launches={coder_launches[de_type]}; equal to the CPU decode")
    waterfall_and_resume("phase4d", ["--family", "wimax", "--n", "576", "--rate", "1/2",
                                     "--snr=1.5,2.0", "--schedule", "flooding",
                                     "--self-correction"], decode_qc_cuda)
    return decs, launches, coder_launches


def phase_nr_main_path():
    code = nr_code(384, 1)
    dec = Decoder(code, NR_CFG, device="cuda")
    if dec.implementation != "cuda_long":
        raise AssertionError(f"NR main path resolved to {dec.implementation}")
    u, llrs = nr_card_llr(code, NR_BATCH, NR_SNRS, SEED + 4)

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
    # a config neither kernel serves on a small-z code (soft output at 310
    # circulants: kernel B's route and kernel C refuse it) is refused on the
    # card: there is no quiet torch path there
    small = nr_code(48, 1)
    try:
        Decoder(small, dataclasses.replace(NR_CFG, soft_output=True), device="cuda")
    except ValueError as e:
        log(f"[phase4b] Decoder({small.name}, soft_output, device=cuda) refused: "
            f"{str(e)[:60]}...")
    else:
        raise AssertionError(f"Decoder({small.name}, soft_output) on the card "
                             "did not raise")

    waterfall_and_resume("phase4b", ["--family", "nr", "--z", "384", "--bg", "1",
                                     "--snr=-2.5,-1.5", "--normalization", "0.8"],
                         decode_qc_long)
    return dec, llrs[5.0], launches


def waterfall_and_resume(tag: str, code_args: list, kernel) -> None:
    """The CLI ``waterfall`` on the card for two SNR points (batch 256, up
    to 512 frames, 30 iterations), then again from its checkpoint, which
    must run no new step and print the same lines.  ``kernel`` is the
    wrapper (``decode_qc_cuda`` or ``decode_qc_long``) whose shared-memory
    launches the first run must count."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.json")
        argv = ["waterfall", *code_args, "--batch", "256", "--target-errors",
                "20", "--max-frames", "512", "--max-iters", "30",
                "--checkpoint", ck, "--out", os.path.join(tmp, "wf.csv"),
                "--device", "cuda"]
        runs = []
        for _ in range(2):
            kernel.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise AssertionError("waterfall exited non-zero")
            with open(ck) as f:
                steps = json.load(f)["steps_done"]
            runs.append((buf.getvalue().strip().splitlines(),
                         kernel.launches, steps))
        (lines, first_launches, steps), (lines2, resumed_launches, steps2) = runs
        for line in lines:
            log(f"[{tag}] waterfall {line}")
        if first_launches < 1:
            raise AssertionError("the waterfall launched no kernel")
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
                                     "1/2", "--snr=0.5,1.0", "--normalization", "0.85"],
                         decode_qc_long)
    return dec, llrs[1.4], launches


def bound(code, cfg, llr, res) -> tuple[float, str]:
    """The least time the card could take for one decode of ``llr``: the
    largest of its bytes (each LLR read once, each output -- bits,
    converged, iterations and, with soft output, posteriors -- written
    once) over the HBM rate, its f32 operations (OPS_PER_EDGE_SWEEP of the
    config's mode per Tanner-graph edge and sweep, over the sweeps this
    run's frames ran: ``iterations`` each with early exit, else every sweep)
    over the f32 rate, and, for sum-product, its special-function results
    over the SFU rate.  Returns (ms, "bytes" or "operations")."""
    batch = llr.shape[0]
    nbytes = batch * code.n * (4 + 1) + batch * (1 + 4)
    if cfg.soft_output:
        nbytes += batch * code.n * 4
    sweeps = (int(res.iterations.sum()) if cfg.early_exit
              else batch * cfg.max_iters)
    if cfg.self_correction:
        key = "scms"
    else:
        key = cfg.schedule
        if cfg.algorithm == "sum-product":
            key = f"sp {cfg.schedule}"
    edge_sweeps = sweeps * code.num_edges
    t_ops = edge_sweeps * OPS_PER_EDGE_SWEEP[key] / PEAK_F32_PER_S
    if cfg.algorithm == "sum-product":
        t_ops = max(t_ops, edge_sweeps * OPS_SFU_PER_EDGE_SWEEP / PEAK_SFU_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
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

    t0 = time.perf_counter()

    def phase(fn, *args):
        out = fn(*args)
        log(f"[time] {fn.__name__} done at {time.perf_counter() - t0:.1f} s")
        return out

    worst = phase(phase_kernel_vs_plain)
    worst_modes, sp_cpu_post = phase(phase_modes_vs_plain)
    worst_b, b_dec, b_llr, b_launches = phase(phase_route_b_vs_plain)
    worst_long = phase(phase_long_kernel_vs_plain)
    worst_shared, worst_global = phase(phase_dvbs2_kernel_vs_plain)
    dec, llr, u, launches, coder_launches, stream = phase(phase_main_path)
    flood_decs, flood_launches, mode_coder_launches = phase(
        phase_flooding_main_path, llr, u, stream)
    nr_dec, nr_llr, nr_launches = phase(phase_nr_main_path)
    dvb_dec, dvb_llr, dvb_launches = phase(phase_dvbs2_main_path)
    times = phase_times(dec, llr, decode_qc_cuda, decode_qc_cuda_plain,
                        dataclasses.replace(BENCH_CFG, triage_iters=0))
    mode_times = {group: phase_times(d, llr, decode_qc_cuda, decode_qc_cuda_plain,
                                     MODE_CFGS[group], plain_reps=3, tag=f" {group}")
                  for group, d in flood_decs.items()}
    b_times = phase_times(b_dec, b_llr, decode_qc_cuda, decode_qc_cuda_plain,
                          NR_CFG, plain_reps=3, tag=" kernel B route")
    nr_times = phase_times(nr_dec, nr_llr, decode_qc_long,
                           decode_qc_long_plain, NR_CFG)
    dvb_times = phase_dvbs2_times(dvb_dec, dvb_llr)["lazy"]
    log(f"[time] phase 5 done at {time.perf_counter() - t0:.1f} s")

    log(smi)

    def entry(name, source, replaces, launches, worst, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"myldpccppapi_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": worst, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"],
                # no single PyTorch call computes a BP decode
                "library_ms": None}

    kernel_a = "myldpccppapi_tpu/ops/pallas_bp.py:249"
    print(json.dumps({"kernels": [
        entry("bp_layered", "bp_layered.cu", kernel_a,
              launches, worst, times, coder_launches=coder_launches),
        # kernel A's modes in the same source, each on its phase-4d path
        entry("bp_layered_flooding", "bp_layered.cu", kernel_a,
              flood_launches["flooding"], worst_modes["flooding"],
              mode_times["flooding"],
              coder_launches=mode_coder_launches["MSCL"]),
        entry("bp_layered_scms", "bp_layered.cu", kernel_a,
              flood_launches["scms"], worst_modes["scms"], mode_times["scms"],
              coder_launches=mode_coder_launches["SCMS"]),
        entry("bp_layered_sum_product", "bp_layered.cu", kernel_a,
              flood_launches["sp"], worst_modes["sp"], mode_times["sp"],
              cpu_posterior_max_abs_err=sp_cpu_post),
        entry("bp_layered_soft_output", "bp_layered.cu", kernel_a,
              flood_launches["soft"], worst_modes["soft"], mode_times["soft"]),
        # kernel B's table-driven route through the same kernel
        entry("bp_layered_route_b", "bp_layered.cu",
              "myldpccppapi_tpu/ops/pallas_bp.py:410", b_launches, worst_b,
              b_times),
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
