"""The multi-rank dry run: one sharded campaign step on each of three legs.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (which stays the
reference's, on a JAX device mesh): the same three legs, configs, frames
per device and SNR ranges, each through ``make_sharded_campaign_step`` on
a mesh over ``n_ranks`` processes (``dist.spawn``) instead of devices:

1. wimax 576 r1/2 + CRC-16 acceptance (plain circulants, matmul encode);
2. DVB-S2 16200 r1/2 (masked partial circulants + multi-edge blocks, IRA
   accumulator encode, post-decode outer-BCH acceptance);
3. NR BG1 z=32 rate-matched rv0 (punctured-front circular buffer,
   triangular encode, CRC-16 acceptance, de-rate-matching).

The mesh is the reference's: (snr 2 x data n/2) with 4 SNR points when
``n_ranks`` is even, else (data n) with 2.  :func:`run_step` and
:func:`step_rank` are the building blocks, also for callers that spawn
their own cases.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..decoder import Decoder
from ..ops import cuda_bp, cuda_long
from ..utils.config import DecoderConfig
from ..utils.device import DEFAULT_DEVICE
from .dist import World, spawn
from .mesh import DATA_AXIS, SNR_AXIS, make_mesh
from .sim import SimStats, make_sharded_campaign_step

__all__ = ["dryrun_multichip", "dryrun_rank", "multichip_legs",
           "multichip_mesh", "run_step", "step_rank"]

#: the legs' decoder configs (``__graft_entry__.py:75-104``)
LEG_CFGS = {
    "wimax576_crc16": DecoderConfig(algorithm="min-sum", schedule="layered",
                                    max_iters=4, crc="16"),
    "dvbs2_16200_bch": DecoderConfig(schedule="layered", normalization=0.85,
                                     max_iters=2),
    "nr_bg1_z32_rm_crc16": DecoderConfig(schedule="layered", normalization=0.8,
                                         max_iters=3, crc="16"),
}

#: the step's collective timed alone this many times (after a warm-up)
COLLECTIVE_REPS = 20


def multichip_mesh(n_ranks: int) -> tuple:
    """(shape, axis names, snr axis, SNR points) of the dry run's mesh."""
    if n_ranks % 2 == 0 and n_ranks >= 2:
        return (2, n_ranks // 2), (SNR_AXIS, DATA_AXIS), SNR_AXIS, 4
    return (n_ranks,), (DATA_AXIS,), None, 2


def multichip_legs(device=DEFAULT_DEVICE) -> list:
    """The three legs on ``device``, each a dict of ``run_step``'s code
    arguments (``code``, ``cfg``, ``encode_fn``, ``decode_fn``, ``outer``,
    ``batch_per_device``) plus its ``name``, the ``decoder`` whose
    implementation it reports and its SNR range ``snr``."""
    from ..codes import (dvbs2, ira_encode_fn, nr_code, rate_match_bits,
                         rate_match_llr, triangular_encode_fn, wimax)
    from ..codes.bch import bch_params_dvbs2

    legs = []
    code1 = wimax(576, "1/2")
    dec1 = Decoder(code1, LEG_CFGS["wimax576_crc16"], device=device)
    legs.append(dict(name="wimax576_crc16", code=code1, encode_fn=None,
                     decode_fn=dec1, decoder=dec1, outer=None,
                     batch_per_device=8, snr=(1.0, 4.0)))
    code2 = dvbs2(16200, "1/2")
    m_f, t_f, _ = bch_params_dvbs2(16200, "1/2")
    dec2 = Decoder(code2, LEG_CFGS["dvbs2_16200_bch"], device=device)
    legs.append(dict(name="dvbs2_16200_bch", code=code2,
                     encode_fn=ira_encode_fn(code2), decode_fn=dec2, decoder=dec2,
                     outer=("bch", m_f, t_f), batch_per_device=2, snr=(1.0, 2.5)))
    code3 = nr_code(z=32, bg=1)
    e3 = code3.n - code3.punctured_front
    tri3 = triangular_encode_fn(code3)
    dec3 = Decoder(code3, LEG_CFGS["nr_bg1_z32_rm_crc16"], device=device)
    legs.append(dict(
        name="nr_bg1_z32_rm_crc16", code=code3,
        encode_fn=lambda u: rate_match_bits(code3, tri3(u), e3),
        decode_fn=lambda llr_e: dec3(rate_match_llr(code3, llr_e, e3).contiguous()),
        decoder=dec3, outer=None, batch_per_device=4, snr=(2.0, 6.0)))
    for leg in legs:
        leg["cfg"] = LEG_CFGS[leg["name"]]
    return legs


def leg_snrs(snr_range: tuple, num_snr: int) -> list:
    """The reference's ``jnp.linspace(lo, hi, num_snr, dtype=float32)``."""
    return [float(x) for x in np.linspace(*snr_range, num_snr, dtype=np.float32)]


def run_step(world: World, code, cfg: DecoderConfig, mesh_shape, axis_names,
             seed: int, snr_db, **step_kwargs) -> SimStats:
    """One step of ``make_sharded_campaign_step`` on this rank, on a mesh of
    ``mesh_shape`` over the group, ``num_snr = len(snr_db)``;
    ``step_kwargs`` go to the step's factory."""
    mesh = make_mesh(mesh_shape, axis_names)
    step = make_sharded_campaign_step(code, cfg, mesh, num_snr=len(snr_db),
                                      device=world.device, **step_kwargs)
    return step(seed, snr_db)


def stats_lists(stats: SimStats) -> dict:
    return {f: [int(x) for x in getattr(stats, f).tolist()] for f in SimStats._fields}


def step_rank(world: World, cases: list) -> list:
    """Worker: :func:`run_step` for each case (a dict of its arguments but
    ``world``), each case's statistics as lists of ints."""
    return [stats_lists(run_step(world, **case)) for case in cases]


def _launch_count(kernel) -> int:
    return kernel.launches + getattr(kernel, "global_launches", 0)


def dryrun_rank(world: World, seed: int = 0) -> dict:
    """Worker: the three legs on this rank, checked as the reference checks
    them; rank 0 prints a line for each.  Returns the wall-clock time the
    rank started them (``ready_at``: after spawn and init), the group's
    backend, each leg's statistics, the ``Decoder``'s implementation and
    its kernel's launches in the step, and the time of one step's
    collective alone (``collective_ms``, the mean of ``COLLECTIVE_REPS``)."""
    ready_at = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    shape, axes, snr_axis, num_snr = multichip_mesh(world.world_size)
    n_data = shape[-1]
    out = {"ready_at": ready_at, "backend": world.backend, "legs": []}
    for leg in multichip_legs(world.device):
        kernel = (cuda_long.decode_qc_long if leg["decoder"].implementation == "cuda_long"
                  else cuda_bp.decode_qc_cuda)
        before = _launch_count(kernel)
        t0 = time.perf_counter()
        stats = run_step(world, leg["code"], leg["cfg"], shape, axes, seed,
                         leg_snrs(leg["snr"], num_snr), snr_axis=snr_axis,
                         batch_per_device=leg["batch_per_device"],
                         encode_fn=leg["encode_fn"], decode_fn=leg["decode_fn"],
                         outer=leg["outer"])
        step_s = time.perf_counter() - t0
        got = stats_lists(stats)
        expect = num_snr * leg["batch_per_device"] * n_data
        if len(got["frames"]) != num_snr or sum(got["frames"]) != expect:
            raise RuntimeError(f"leg {leg['name']}: frames {got['frames']}, "
                               f"expected {expect} over {num_snr} points")
        if world.rank == 0:
            print(f"dryrun_multichip[{leg['name']}] OK: mesh={dict(zip(axes, shape))} "
                  f"frames={sum(got['frames'])} "
                  f"frame_errors={sum(got['frame_errors'])}", flush=True)
        out["legs"].append(dict(name=leg["name"], stats=got, step_s=step_s,
                                implementation=leg["decoder"].implementation,
                                launches=_launch_count(kernel) - before))
    out["collective_ms"] = _collective_ms(world, num_snr)
    return out


def _collective_ms(world: World, num_snr: int) -> float:
    """Mean ms of the step's ``all_reduce`` of ``[fields, num_snr]`` int64
    on this rank's device, after a barrier and a warm-up."""
    buf = torch.zeros((len(SimStats._fields), num_snr), dtype=torch.int64,
                      device=world.device)
    dist.all_reduce(buf)
    dist.barrier()
    sync = torch.cuda.synchronize if world.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(COLLECTIVE_REPS):
        dist.all_reduce(buf)
    sync()
    return (time.perf_counter() - t0) / COLLECTIVE_REPS * 1e3


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device=DEFAULT_DEVICE) -> list:
    """Spawn ``n_ranks`` ranks on ``device`` (``dist.spawn``: the backend
    rule there) and run :func:`dryrun_rank` in each; returns each rank's
    report in rank order."""
    return spawn(dryrun_rank, n_ranks, backend, device)
