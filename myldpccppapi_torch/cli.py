"""Command-line harness.

Counterpart of the ``test`` and ``waterfall`` subcommands of
``myldpccppapi_tpu/cli.py``:

``test``      — the reference CLI's encode -> AWGN -> decode roundtrip
                (``Test.cpp:15-118``): same positional semantics
                (srcLength, batchSize, snr, algo), same printed metrics
                (decode wall time, ErrNum, ThroughPut).
``waterfall`` — BER/FER campaign over an SNR grid on one device, with
                checkpoint/resume and CSV/JSON output; the same per-point
                lines as the reference.

Both run on the card; ``--device cpu`` is the only way onto the CPU.

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
"""
from __future__ import annotations

import argparse
import json
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
    """BER/FER waterfall over an SNR grid on one device."""
    from .campaign import CampaignConfig, WaterfallCampaign
    from .codes.dvbs2 import ira_encode_fn
    from .codes.nr import triangular_encode_fn
    from .sim import make_decode_fn, matmul_encode_fn, sim_step
    from .utils.config import DecoderConfig
    from .utils.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    device = resolve_device(args.device)
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
    # the decoder comes from the standard implementation dispatch; only
    # the encoder is family-specific
    if args.family == "nr":
        encode_fn = triangular_encode_fn(code)
    elif args.family == "dvbs2":
        encode_fn = ira_encode_fn(code)  # O(n) accumulator encode
    else:
        encode_fn = matmul_encode_fn(code, device=device)
    decode_fn = make_decode_fn(code, cfg, device=device)

    def step_fn(seed, snr_db):
        gen = torch.Generator(device=device).manual_seed(seed)
        stats = sim_step(code, cfg, gen, snr_db, args.batch, encode_fn,
                         decode_fn, mod=mod, demap=args.demap,
                         id_outer=args.id_outer, outer=outer)
        return type(stats)(*(int(x) for x in stats))

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
        + (f"/mod={args.mod}/demap={args.demap}/id_outer={args.id_outer}"
           if mod is not None else "")
        + (f"/outer={outer}" if outer is not None else ""))
    camp = WaterfallCampaign(ccfg, step_fn, frames_per_step=args.batch,
                             fingerprint=fp, checkpoint_path=args.checkpoint)

    def progress(i, p):
        if args.verbose:
            print(
                f"snr={p.snr_db:+.2f} frames={p.frames} fer={p.fer:.3e} "
                f"ber={p.ber:.3e} iters={p.avg_iters:.1f}",
                file=sys.stderr,
            )

    camp.run(progress=progress)
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
                   choices=["layered", "flooding"])
    w.add_argument("--max-iters", type=int, default=40)
    w.add_argument("--normalization", type=float, default=1.0)
    w.add_argument("--self-correction", action="store_true",
                   dest="self_correction",
                   help="SCMS (Savin): sign-flip message erasure; min-sum "
                        "flooding only")
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
    w.add_argument("-v", "--verbose", action="store_true")
    w.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default: cuda; cpu for the CPU)")
    w.set_defaults(fn=cmd_waterfall)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
