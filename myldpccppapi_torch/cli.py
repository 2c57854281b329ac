"""Command-line harness.

Counterpart of ``myldpccppapi_tpu/cli.py``:

``test``      — the reference CLI's encode -> AWGN -> decode roundtrip
                (``Test.cpp:15-118``): same positional semantics
                (srcLength, batchSize, snr, algo), same printed metrics
                (decode wall time, ErrNum, ThroughPut).
``waterfall`` — BER/FER campaign over an SNR grid, with checkpoint/resume
                and CSV/JSON output; the same per-point lines as the
                reference.  It always goes through the sharded campaign
                step (parallel/sim.py), as the reference's does: one rank
                when run alone, N ranks under ``python -m
                torch.distributed.run --nproc-per-node N``, where rank 0
                alone prints and writes ``--out`` and the checkpoint.
``threshold`` — PEXIT decoding threshold of a code (host-side NumPy).
``design``    — PEXIT-guided search over an NR base-graph support or a
                DVB-S2 IRA profile (host-side NumPy).
``probe``     — error-impulse floor probe through ``Decoder`` on the
                device (the production kernels on the card).
``bench``     — the headline throughput at the root ``bench.py``'s
                operating point, against the port's own C++ golden
                (:mod:`.bench`); one JSON line.

``test``, ``waterfall``, ``probe`` and ``bench`` run on the card;
``--device cpu`` is the only way onto the CPU.
Under ``torch.distributed.run`` the backend is ``--dist-backend``, or by
default nccl on CUDA ranks that have a card each and gloo on the CPU;
ranks that share a card need ``--dist-backend gloo`` (parallel/dist.py).

Examples::

    python -m myldpccppapi_torch test 4320 64 3.0 TDMPCL
    python -m myldpccppapi_torch waterfall --family nr --z 384 --bg 1 \
        --snr 1,1.5 --batch 512 --target-errors 50 --max-iters 30 \
        --normalization 0.8 --checkpoint ck.json --out nr.csv
    python -m myldpccppapi_torch waterfall --family dvbs2 --n 16200 \
        --rate 1/2 --snr 1.5,2 --batch 256 --max-iters 30 --normalization 0.85
    python -m myldpccppapi_torch waterfall --family wimax --n 576 \
        --rate 1/2 --snr 2,3 --schedule flooding --self-correction
    python -m myldpccppapi_torch waterfall --family dvbs2 --n 16200 \
        --rate 3/4 --mod 16apsk --id-outer 2 --snr 13.9 --max-iters 30 \
        --normalization 0.85
    python -m myldpccppapi_torch waterfall --family regular --n 648 \
        --algorithm sum-product --schedule flooding --crc 16 --snr 2
    python -m myldpccppapi_torch waterfall --family dvbs2 --n 16200 \
        --rate 1/2 --bch --snr 1.5,2 --normalization 0.85 --max-iters 30
    python -m myldpccppapi_torch waterfall --family wimax --n 576 \
        --rate 1/2 --msg-dtype bfloat16 --snr 2,3
    python -m myldpccppapi_torch waterfall --family rs_ldpc --n 2048 \
        --snr 6,6.5 --normalization 0.75 --max-iters 20
    python -m myldpccppapi_torch waterfall --family wifi --n 1944 \
        --rate 5/6 --snr 6.5 --normalization 0.75
    python -m myldpccppapi_torch threshold --family nr --z 384 --bg 2
    python -m myldpccppapi_torch design --family nr --bg 2 --steps 300
    python -m myldpccppapi_torch probe --family wimax --n 576 --rate 1/2
    python -m myldpccppapi_torch bench
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m myldpccppapi_torch -- waterfall --family dvbs2 --n 16200 \
        --rate 1/2 --snr 0.5:4:0.5 --batch 1024 --normalization 0.8 \
        --max-iters 25 --snr-shards 2 --dist-backend gloo

(The ``--`` after the module keeps the launcher's own parser off the
command's options: it would take ``--n`` for an abbreviation of one of
its own.)
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from .coder import DECODE_TYPES
from .utils.device import DEFAULT_DEVICE


def cmd_test(args) -> int:
    """Reference-style roundtrip: plaintext -> encode -> AWGN -> decode."""
    from .coder import Coder

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    coder = Coder(args.k, args.n, args.rate, device=args.device,
                  msg_dtype=args.msg_dtype)
    coder.for_encoder()
    coder.for_decoder(args.batch)
    src = bytes((ord("a") + i % 26) for i in range(args.src_length))

    t0 = time.perf_counter()
    prior = coder.encode(src)
    t_enc = time.perf_counter() - t0
    sigma = 10 ** (-args.snr / 20)
    post = coder.test(prior, sigma, seed=args.seed)

    # arming: build the decoder (and the CUDA kernel) outside the timed
    # region, like the reference's forDecoder/addDecodeType device setup
    if args.algo != "CPU":
        coder.decode(np.zeros_like(post), len(src), de_type=args.algo)

    t0 = time.perf_counter()
    decoded, stats = coder.decode(post, len(src), de_type=args.algo,
                                  return_stats=True)
    t_dec = time.perf_counter() - t0

    err = int(np.sum(np.frombuffer(src, np.uint8) != decoded[: len(src)]))
    print(f"EncodeTime={t_enc:.6f}s DecodeTime={t_dec:.6f}s")
    # the reference prints the BP iteration count per batch ("Time=<iters>",
    # MyLdpc.cpp:838)
    print(f"Time={stats['mean_iters']:.1f}")
    print(f"ErrNum={err}")
    print(f"ThroughPut={len(src) / t_dec:.1f} byte/s")
    return 0 if err == 0 else 1


def _parse_snr_grid(spec: str):
    """"a:b:step" inclusive grid, or comma list "1,2,3"."""
    if ":" in spec:
        parts = [float(x) for x in spec.split(":")]
        a, b = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 1.0
        n = int(round((b - a) / step)) + 1
        return [round(a + i * step, 6) for i in range(n)]
    return [float(x) for x in spec.split(",")]


def _make_code(args):
    if args.family == "regular":
        from .codes import regular

        return regular(args.n)
    if args.family == "wimax":
        from .codes import wimax

        return wimax(args.n, args.rate)
    if args.family == "dvbs2":
        from .codes import dvbs2

        return dvbs2(args.n, args.rate)
    if args.family == "wifi":
        from .codes import wifi

        return wifi(args.n, args.rate)
    if args.family == "rs_ldpc":
        # 802.3an-class RS-based LDPC: n = 32 * 2^s (2048 = the standard's)
        from .codes import rs_ldpc_from_n

        try:
            return rs_ldpc_from_n(args.n)
        except ValueError as e:
            raise SystemExit(str(e))
    from .codes import nr_code

    return nr_code(z=args.z, bg=args.bg)


def cmd_waterfall(args) -> int:
    """BER/FER waterfall over an SNR grid through the sharded campaign
    step, on this process's rank of the group (one rank when run alone)."""
    from .parallel import dist as pdist

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        stream=sys.stderr)
    world = pdist.init_from_env(args.dist_backend, args.device)
    try:
        return _waterfall(args, world)
    finally:
        pdist.shutdown(world)


def _waterfall(args, world) -> int:
    from .campaign import CampaignConfig, WaterfallCampaign
    from .codes.dvbs2 import ira_encode_fn
    from .codes.nr import triangular_encode_fn
    from .parallel import make_mesh, make_sharded_campaign_step
    from .sim import SimStats, matmul_encode_fn
    from .utils.config import DecoderConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    device = world.device
    n_ranks = world.world_size
    snr_shards = max(1, args.snr_shards)
    if n_ranks % snr_shards:
        raise SystemExit(
            f"--snr-shards {snr_shards} must divide the rank count {n_ranks}")
    code = _make_code(args)
    mod = None
    if args.mod != "bpsk":
        from .ops.modulation import make_modulation

        # the rate picks APSK's EN 302 307 ring ratio
        mod = make_modulation(args.mod, rate=args.rate)
        if code.n % mod.bits_per_symbol:
            raise SystemExit(f"n={code.n} not divisible by "
                             f"{mod.bits_per_symbol} bits/symbol of {args.mod}")
    elif args.id_outer:
        raise SystemExit("--id-outer (BICM-ID) needs --mod other than bpsk")
    outer = None
    if args.bch:
        if args.family != "dvbs2":
            raise SystemExit("--bch is the DVB-S2 outer code; use --crc "
                             "for other families")
        if args.crc:
            raise SystemExit("--crc and --bch are mutually exclusive "
                             "acceptance modes")
        from .codes.bch import bch_params_dvbs2

        m_f, t_f, _ = bch_params_dvbs2(args.n, args.rate)
        outer = ("bch", m_f, t_f)
    cfg = DecoderConfig(algorithm=args.algorithm, schedule=args.schedule,
                        max_iters=args.max_iters,
                        normalization=args.normalization,
                        msg_dtype=args.msg_dtype, crc=args.crc,
                        self_correction=args.self_correction)
    if snr_shards > 1:
        # the BASELINE config-5 layout: SNR points across one mesh axis,
        # codeword batch across the other
        mesh = make_mesh((snr_shards, n_ranks // snr_shards), ("snr", "data"))
    else:
        mesh = make_mesh((n_ranks,), ("data",))
    data_ranks = n_ranks // snr_shards
    batch_per_rank = max(1, args.batch // data_ranks)
    # the decoder comes from the standard implementation dispatch; only
    # the encoder is family-specific
    if args.family == "nr":
        encode_fn = triangular_encode_fn(code)
    elif args.family == "dvbs2":
        encode_fn = ira_encode_fn(code)  # O(n) accumulator encode
    else:
        encode_fn = matmul_encode_fn(code, device=device)
    step = make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=batch_per_rank, num_snr=snr_shards,
        encode_fn=encode_fn, snr_axis="snr" if snr_shards > 1 else None,
        outer=outer, mod=mod, demap=args.demap, id_outer=args.id_outer,
        device=device)

    def step_fn(seed, snr_db):
        snrs = snr_db if isinstance(snr_db, (list, tuple)) else [snr_db]
        return SimStats(*torch.stack(tuple(step(seed, snrs))).cpu().numpy())

    ccfg = CampaignConfig(
        snr_db=_parse_snr_grid(args.snr),
        batch_per_step=args.batch,
        min_frame_errors=args.target_errors,
        max_frames=args.max_frames,
        seed=args.seed,
    )
    # the generator's numbers depend on the device type: a checkpoint
    # resumes only on the same kind of device
    fp = ccfg.fingerprint(
        code.name, repr(cfg) + f"/device={device.type}"
        + f"/snr_shards={snr_shards}/outer={outer}"
        + (f"/mod={args.mod}/demap={args.demap}/id_outer={args.id_outer}"
           if mod is not None else ""))
    camp = WaterfallCampaign(ccfg, step_fn,
                             frames_per_step=batch_per_rank * data_ranks,
                             fingerprint=fp, checkpoint_path=args.checkpoint,
                             snr_group_size=snr_shards, rank=world.rank)
    lead = world.rank == 0

    def progress(i, p):
        if args.verbose and lead:
            print(
                f"snr={p.snr_db:+.2f} frames={p.frames} fer={p.fer:.3e} "
                f"ber={p.ber:.3e} iters={p.avg_iters:.1f}",
                file=sys.stderr,
            )

    camp.run(progress=progress)
    if not lead:
        return 0
    if args.out:
        if args.out.endswith(".json"):
            with open(args.out, "w") as f:
                json.dump(camp.report(), f, indent=2)
        else:
            camp.write_csv(args.out)
    for p in camp.points:
        split = ""
        if p.frame_errors:
            split = f" det/undet={p.detected_errors}/{p.undetected_errors}"
        print(
            f"snr={p.snr_db:+.2f} frames={p.frames} FER={p.fer:.4e} "
            f"BER={p.ber:.4e} (+-{p.fer_ci95():.1e}) iters={p.avg_iters:.2f}"
            + split
        )
    return 0


def cmd_threshold(args) -> int:
    """PEXIT decoding threshold of a code family (host-side analysis)."""
    import math

    from .codes.pexit import protograph, threshold_ebn0

    code = _make_code(args)
    thr = threshold_ebn0(code)
    pf = getattr(code, "punctured_front", 0)
    rate = code.k_info / (code.n - pf)
    print(f"code={code.name} rate_tx={rate:.4f} "
          f"edges={int(protograph(code).sum())}")
    print(f"threshold_ebn0_db={thr:.3f}")
    # sigma* in closed form from the threshold (no second bisection)
    sigma = (0.0 if not math.isfinite(thr)
             else 1.0 / math.sqrt(2.0 * rate * 10.0 ** (thr / 10.0)))
    print(f"threshold_sigma={sigma:.4f}")
    return 0


def cmd_design(args) -> int:
    """PEXIT-guided base-graph / profile design (host-side search)."""
    if args.family == "nr":
        from .codes.design import _threshold as nr_threshold
        from .codes.design import nr_support_default, optimize_nr_support

        start = nr_support_default(args.bg)
        t0 = nr_threshold(start.astype(int), args.bg, -3.0, 10.0, 0.02)
        b, thr = optimize_nr_support(bg=args.bg, steps=args.steps,
                                     seed=args.seed,
                                     log_every=args.steps // 10 or 1)
        print(f"legacy threshold:   {t0:.3f} dB")
        print(f"designed threshold: {thr:.3f} dB  ({b.sum()} edges)")
        if args.out:
            np.save(args.out, b)
            print(f"support saved to {args.out} — lift with "
                  f"nr_code(bg={args.bg}, table=nr_base_graph({args.bg}, "
                  f"support=np.load(...)))")
        return 0
    from .codes.design import optimize_dvbs2_profile, realize_dvbs2_addresses

    bi, thr = optimize_dvbs2_profile(
        args.n, args.rate, steps=args.steps, seed=args.seed,
        log_every=args.steps // 10 or 1)
    print(f"designed threshold: {thr:.3f} dB  ({bi.sum()} edges)")
    addrs = realize_dvbs2_addresses(bi, args.n, args.rate)
    if args.out:
        with open(args.out, "w") as f:
            for a in addrs:
                f.write(" ".join(str(x) for x in a) + "\n")
        print(f"address table saved to {args.out} — load with "
              f"dvbs2(n, rate, addresses=parse_address_table(open(...)"
              f".read()))")
    return 0


def cmd_probe(args) -> int:
    """Error-impulse floor probe: d_min bound + trapped-set fingerprint,
    decoded through ``Decoder`` on ``--device``."""
    from .ops.impulse import impulse_probe

    code = _make_code(args)
    r = impulse_probe(code, amplitude=args.amplitude,
                      max_pair_patterns=args.max_pairs, device=args.device)
    print(f"code={code.name} probes={r.probes} amplitude={args.amplitude}")
    if r.min_weight is not None:
        print(f"min_weight={r.min_weight} "
              f"support_cols={r.support_cols.tolist()}")
    else:
        print("min_weight=none (no impulse broke through to a codeword)")
    print(f"breaches={r.breaches} trapped={len(r.trapped)}")
    return 0


def cmd_bench(args) -> int:
    from . import bench

    return bench.main(args.device)


def _code_args(p, families) -> None:
    p.add_argument("--family", default="wimax", choices=families)
    p.add_argument("--n", type=int, default=576)
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=384, help="NR lifting size")
    p.add_argument("--bg", type=int, default=1, choices=[1, 2],
                   help="NR base graph")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="myldpccppapi_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("test", help="reference-style roundtrip self-test")
    t.add_argument("src_length", type=int)
    t.add_argument("batch", type=int)
    t.add_argument("snr", type=float)
    t.add_argument("algo", choices=sorted(DECODE_TYPES),
                   help="decode type (reference Test.cpp names)")
    t.add_argument("--n", type=int, default=576)
    t.add_argument("--k", type=int, default=432)
    t.add_argument("--rate", default="3/4B")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--msg-dtype", default="float32", dest="msg_dtype",
                   choices=["float32", "bfloat16"],
                   help="decoder message precision (bfloat16 halves the "
                        "kernels' message bytes)")
    t.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: cuda; cpu for the CPU)")
    t.set_defaults(fn=cmd_test)

    w = sub.add_parser("waterfall", help="BER/FER waterfall campaign")
    w.add_argument("--family", default="wimax",
                   choices=["wimax", "wifi", "regular", "nr", "dvbs2",
                            "rs_ldpc"])
    w.add_argument("--n", type=int, default=576,
                   help="code length (wimax; wifi: 648, 1296 or 1944; "
                        "regular: a multiple of 6; dvbs2: 16200 or 64800; "
                        "rs_ldpc: 32 * 2^s, 2048 the 802.3an code)")
    w.add_argument("--rate", default="1/2", help="wimax, wifi or dvbs2 rate")
    w.add_argument("--z", type=int, default=384, help="NR lifting size")
    w.add_argument("--bg", type=int, default=1, choices=[1, 2],
                   help="NR base graph")
    w.add_argument("--snr", default="0:4:0.5", help='grid "a:b:step" or "1,2,3"')
    w.add_argument("--batch", type=int, default=1024)
    w.add_argument("--algorithm", default="min-sum",
                   choices=["min-sum", "sum-product"])
    w.add_argument("--schedule", default="layered",
                   choices=["layered", "flooding"],
                   help="flooding runs on the short-code kernel where it "
                        "serves the code, else (long codes) on torch ops "
                        "on the card, as the reference's jnp path")
    w.add_argument("--max-iters", type=int, default=40)
    w.add_argument("--normalization", type=float, default=1.0)
    w.add_argument("--self-correction", action="store_true",
                   dest="self_correction",
                   help="SCMS (Savin): sign-flip message erasure; min-sum "
                        "flooding only: the short-code kernel where it "
                        "serves the code, else torch ops on the card")
    w.add_argument("--msg-dtype", default="float32", dest="msg_dtype",
                   choices=["float32", "bfloat16"],
                   help="decoder message precision (bfloat16 halves the "
                        "kernels' message bytes)")
    w.add_argument("--target-errors", type=int, default=100)
    w.add_argument("--max-frames", type=int, default=1_000_000)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--checkpoint", default=None)
    w.add_argument("--out", default=None, help=".csv or .json")
    w.add_argument("--crc", default=None, choices=["24A", "24B", "24C", "16"],
                   help="CRC-aided acceptance (TS 38.212 §5.1): attach this "
                        "CRC to each simulated code block and require "
                        "syndrome AND CRC for frame acceptance")
    w.add_argument("--bch", action="store_true",
                   help="DVB-S2 outer BCH (EN 302 307): fill the BCHFEC "
                        "parity field and require syndrome AND BCH "
                        "detection for frame acceptance")
    w.add_argument("--mod", default="bpsk",
                   choices=["bpsk", "qpsk", "8psk", "16qam", "64qam",
                            "256qam", "16apsk", "32apsk"],
                   help="constellation (NR QAM per TS 38.211 §5.1; DVB-S2 "
                        "PSK/APSK geometry per EN 302 307 §5.4); soft "
                        "demapping feeds the decoder")
    w.add_argument("--demap", default="maxlog", choices=["maxlog", "exact"],
                   help="soft-demapper flavor for --mod != bpsk")
    w.add_argument("--id-outer", type=int, default=0, dest="id_outer",
                   help="BICM-ID: demapper<->decoder extrinsic exchanges "
                        "after the first pass (needs --mod != bpsk)")
    w.add_argument("--snr-shards", type=int, default=1, dest="snr_shards",
                   help="shard the SNR grid over this many mesh shards "
                        "(must divide the rank count): groups of N SNR "
                        "points run simultaneously on an (snr x data) mesh "
                        "of ranks — the BASELINE config-5 layout")
    w.add_argument("--dist-backend", default=None, dest="dist_backend",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend under torch.distributed."
                        "run (default: nccl on CUDA ranks with a card each, "
                        "gloo on the CPU; ranks sharing a card need gloo)")
    w.add_argument("-v", "--verbose", action="store_true")
    w.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: cuda; cpu for the CPU); "
                        "each rank takes cuda:LOCAL_RANK %% device count")
    w.set_defaults(fn=cmd_waterfall)

    b = sub.add_parser("bench", help="headline throughput benchmark (one "
                                     "JSON line)")
    b.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: cuda; cpu for the CPU)")
    b.set_defaults(fn=cmd_bench)

    families = ["wimax", "wifi", "regular", "nr", "dvbs2", "rs_ldpc"]
    th = sub.add_parser(
        "threshold",
        help="PEXIT decoding threshold (density evolution on the protograph)")
    _code_args(th, families)
    th.set_defaults(fn=cmd_threshold)

    d = sub.add_parser(
        "design",
        help="PEXIT-guided threshold descent on a base graph / IRA profile")
    d.add_argument("--family", default="nr", choices=["nr", "dvbs2"])
    d.add_argument("--bg", type=int, default=2, choices=[1, 2],
                   help="NR base graph")
    d.add_argument("--n", type=int, default=16200)
    d.add_argument("--rate", default="1/2")
    d.add_argument("--steps", type=int, default=300)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default=None,
                   help=".npy (nr support) / text table (dvbs2 addresses)")
    d.set_defaults(fn=cmd_design)

    pr = sub.add_parser(
        "probe",
        help="error-impulse floor probe (d_min bound, trapped-set "
             "fingerprint) on the production decode path")
    _code_args(pr, families)
    pr.add_argument("--amplitude", type=float, default=8.0)
    pr.add_argument("--max-pairs", type=int, default=2048, dest="max_pairs")
    pr.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default: cuda; cpu for the CPU)")
    pr.set_defaults(fn=cmd_probe)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
