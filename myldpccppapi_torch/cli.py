"""Command-line harness.

``test`` — the reference CLI's encode -> AWGN -> decode roundtrip
(``Test.cpp:15-118``): same positional semantics (srcLength, batchSize, snr,
algo), same printed metrics (decode wall time, ErrNum, ThroughPut).
Counterpart of the ``test`` subcommand of ``myldpccppapi_tpu/cli.py``.

Example::

    python -m myldpccppapi_torch test 4320 64 3.0 TDMPCL --device cuda
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .coder import DECODE_TYPES


def cmd_test(args) -> int:
    """Reference-style roundtrip: plaintext -> encode -> AWGN -> decode."""
    from .coder import Coder

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    coder = Coder(args.k, args.n, args.rate, device=args.device)
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
    t.add_argument("--device",
                   default="cuda" if torch.cuda.is_available() else "cpu",
                   help="torch device (default: cuda when available)")
    t.set_defaults(fn=cmd_test)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
