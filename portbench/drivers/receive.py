"""Closed-loop receive traffic: one ``Decoder`` call outstanding at a time.

The traffic file gives ``batch`` frames a call at ``snr_db`` (Es/N0 with
BPSK of amplitude 1: sigma = 10^(-snr_db/20), LLR = 2 y / sigma^2), and
``sets`` noise realizations staged on the card before the window, which
the calls cycle through.  Info bits, codewords (the reference's encoder)
and noise come from one ``torch.Generator`` on the card seeded with
``--seed``; the program and the reference get the same LLR tensor.

A call is timed on the host clock from its submit until
``torch.cuda.synchronize()`` returns.  ``info_mbps`` is the information
bits of every call completed in the window over the window's wall time;
``call_p95_ms`` the 95th percentile of every call's time.

``correct``: ``check_calls`` calls drawn from the seed (:func:`_sample`)
keep their results; after the window the reference
decodes their realizations and every frame's bits, converged flag and
iteration count must equal it.  The named launch counter must have risen
by one for every call of the window, and no other.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["COUNTERS", "run", "stage"]

#: the long-code kernels' launch counters (ops/cuda_long.py)
COUNTERS = ("launches", "global_launches")
#: profiled calls before the traced slice opens: the profiler's first
#: records carry its own start-up
LEAD_IN = 2
#: realizations made at a time while staging
STAGE_SETS = 8


def stage(ref_family, code, traffic: dict, seed: int, device):
    """(info bits [sets, batch, k] uint8, LLRs [sets, batch, n] f32) on
    ``device`` from ``seed``; a punctured position's LLR is 0.  The
    codewords and noise are made ``STAGE_SETS`` sets at a time, so the
    peak holds the LLRs and one group's codewords, not all of them twice."""
    import torch

    sets, batch = traffic["sets"], traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randint(0, 2, (sets, batch, code.k), generator=gen, device=device,
                      dtype=torch.uint8)
    sigma = 10.0 ** (-traffic["snr_db"] / 20.0)
    llr = torch.empty((sets, batch, code.n), device=device, dtype=torch.float32)
    for lo in range(0, sets, STAGE_SETS):
        part = llr[lo:lo + STAGE_SETS]
        sym = ref_family.encode(code, u[lo:lo + STAGE_SETS].reshape(-1, code.k))
        sym = 1.0 - 2.0 * sym.to(torch.float32).view(part.shape)
        part.normal_(generator=gen).mul_(sigma).add_(sym).mul_(2.0 / sigma ** 2)
        del sym
    llr[..., :code.punctured_front] = 0.0
    return u, llr


def _sample(traffic: dict, seed: int) -> set:
    """The calls whose results the check keeps, drawn from the seed:
    ``check_calls`` realizations (distinct while there are as many), each
    at one of its occurrences among the first ``check_within`` calls."""
    rng = np.random.default_rng(seed)
    sets, n = traffic["sets"], traffic["check_calls"]
    chosen = rng.permutation(sets)[:n] if n <= sets else rng.integers(sets, size=n)
    reps = max(1, traffic["check_within"] // sets)
    return {int(s) + sets * int(rng.integers(reps)) for s in chosen}


def _counters():
    from myldpccppapi_torch.ops.cuda_long import decode_qc_long

    return {c: getattr(decode_qc_long, c) for c in COUNTERS}


def run(cell, seed: int, seconds: float, trace: bool, t0: float, *,
        device="cuda", wrap_decoder=None, decoder_overrides=None) -> dict:
    """One run of a receive cell.  ``wrap_decoder`` (a function of the
    ``Decoder``) and ``decoder_overrides`` (DecoderConfig fields) serve the
    tests: a fault planted under the timed path, the control's bf16."""
    import torch

    from myldpccppapi_torch import Decoder, DecoderConfig
    from portbench.reference import qc as refqc

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg, traffic, expect = cell.config, cell.traffic, cell.workload
    text = cell.table_text()
    fam = cell.reference_family()
    code = fam.build(cfg, fam.parse(text))
    dcfg = DecoderConfig(**{**cfg["decoder"], **(decoder_overrides or {})})
    dec = Decoder(cell.program_family().program_code(cfg, text), dcfg, device=dev)
    if dec.implementation != expect["implementation"]:
        raise RuntimeError(f"Decoder.implementation is {dec.implementation!r}, the "
                           f"cell names {expect['implementation']!r}")
    call = dec if wrap_decoder is None else wrap_decoder(dec)
    sets, batch = traffic["sets"], traffic["batch"]
    _, llr = stage(fam, code, traffic, seed, dev)

    # warm-up: the cell's one shape, for warmup_s and at least once a set
    w0, n = time.perf_counter(), 0
    while n < sets or time.perf_counter() - w0 < traffic["warmup_s"]:
        call(llr[n % sets])
        sync()
        n += 1
    sample = _sample(traffic, seed)
    tr_lo = traffic["trace_start"] if trace else -1
    tr_hi = tr_lo + traffic["trace_calls"] if trace else -1
    prof = slice_span = None
    slice_launches, slice_sets = 0, []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        # the profiler's first start takes seconds: pay it in set-up
        with profile(activities=acts):
            call(llr[0])
            sync()
        prof = profile(activities=acts)
    profiling = False
    counted = _counters() if expect.get("counter") else None
    kept, lat, res = {}, [], None
    perf = time.perf_counter
    first_call = time.time()
    c = 0
    start = perf()
    end_at = start + seconds
    while perf() < end_at:
        if c == tr_lo - LEAD_IN:
            prof.start()
            profiling = True
        if c == tr_lo:
            slice_span = record_function("portbench.slice")
            slice_span.__enter__()
        if tr_lo <= c < tr_hi:
            before = _counters()
            with record_function("portbench.call"):
                a = perf()
                with record_function("portbench.submit"):
                    res = call(llr[c % sets])
                with record_function("portbench.sync"):
                    sync()
                lat.append(perf() - a)
            after = _counters()
            slice_launches += sum(after[k] - before[k] for k in COUNTERS)
            slice_sets.append(c % sets)
            if c == tr_hi - 1:
                slice_span.__exit__(None, None, None)
                slice_span = None
                prof.stop()
                profiling = False
        else:
            a = perf()
            res = call(llr[c % sets])
            sync()
            lat.append(perf() - a)
        if c in sample:
            kept[c] = res
        c += 1
    stop = perf()
    if slice_span is not None:  # the window closed inside the slice
        slice_span.__exit__(None, None, None)
    if profiling:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launch_off = 0
    if counted is not None:
        now = _counters()
        for k in COUNTERS:
            rose = now[k] - counted[k]
            launch_off += abs(rose - c) if k == expect["counter"] else rose
    del call, dec, res

    # the reference, on the realizations the kept calls and the slice used
    need = sorted({k % sets for k in kept} | set(slice_sets))
    ref = {}
    if need:
        got = refqc.decode(code, llr[need].reshape(-1, code.n),
                           alpha=dcfg.normalization, beta=dcfg.offset,
                           max_iters=dcfg.max_iters, early_exit=dcfg.early_exit,
                           lazy=dcfg.syndrome_mode == "lazy")
        for i, s in enumerate(need):
            part = slice(i * batch, (i + 1) * batch)
            ref[s] = (got.bits[part], got.converged[part], got.iterations[part])
    bits_off = conv_off = iters_off = failed = 0
    for k, res in kept.items():
        bits, conv, iters = ref[k % sets]
        b = int((res.bits.to(torch.uint8) != bits).any(1).sum())
        v = int((res.converged.bool() != conv).sum())
        i = int((res.iterations.to(torch.int32) != iters).sum())
        bits_off, conv_off, iters_off = bits_off + b, conv_off + v, iters_off + i
        failed += (b + v + i) > 0
    check = {"bits_off": (bits_off, 0), "conv_off": (conv_off, 0),
             "iters_off": (iters_off, 0), "launch_off": (launch_off, 0),
             "calls_unchecked": (0 if kept else 1, 0)}
    window = stop - start
    out = {
        "attempted": c, "failed": failed, "checked_calls": len(kept),
        "e2e": {"setup_s": first_call - t0,
                "info_mbps": c * batch * code.k / window / 1e6,
                "call_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))},
        "check": check, "memory_peak_bytes": peak,
        "reference": {"mean_sweeps": (float(np.mean([ref[s][2].float().mean().item()
                                                       for s in ref])) if ref else None),
                      "converged": (float(np.mean([ref[s][1].float().mean().item()
                                                     for s in ref])) if ref else None)},
    }
    if trace:
        from portbench.trace import Trace

        out["trace"] = Trace(prof.profiler.kineto_results.events()
                             if prof.profiler is not None else [])
        out["ctx"] = {"code": {"n": code.n, "edges": code.edges, "batch": batch},
                      "slice_sets": slice_sets,
                      "slice_launches": slice_launches,
                      "ref_sweeps": {s: int(ref[s][2].sum()) for s in ref}}
    return out
