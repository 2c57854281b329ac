"""The sharded campaign step: one SNR grid over the ranks of a mesh.

Counterpart of ``make_sharded_campaign_step`` in
``myldpccppapi_tpu/parallel/sim.py``, which re-exports ``SimStats`` and
``sim_step`` (here from the single-device ``myldpccppapi_torch/sim.py``)
beside it.  The reference shards one jitted program over a device mesh
with ``shard_map`` and ``psum``s the per-SNR statistics over the data
axis; here every rank of the mesh (``mesh.py``) is a process that runs the
same step in lockstep:

* the SNR grid is split into contiguous blocks over the ``snr`` axis, as
  ``P(snr)`` splits it: snr shard s takes points ``s * L .. s * L + L - 1``
  of the ``num_snr = n_snr_shards * L``;
* each data rank simulates ``batch_per_device`` frames per local point;
* the statistics are summed over the data axis, and gathered over the snr
  axis, by one ``all_reduce`` of a ``[fields, num_snr]`` int64 tensor over
  the whole group, in which each rank fills only its own points' columns
  (gloo runs ``all_reduce`` on CUDA tensors, so ranks that share a card
  can use it);
* along any other axis (BASELINE config 5's ``("host", "data")`` mesh
  with no snr axis) the reference computes duplicates and returns one
  copy: here those ranks compute the same draws, and only the one at
  coordinate 0 on every such axis fills its columns, so nothing is
  counted twice.  A rank past the mesh fills nothing.

Every field of the result is an int64 tensor of shape ``[num_snr]`` on the
rank's device, the same on every rank.

Seeds.  The reference folds the mesh position ``d * n_snr_shards + s``
(d the data coordinate, s the snr coordinate) into its threefry key and
splits the result once per local point.  Threefry is not reproduced
here; the port's rule is that local point i of the rank at position p
draws from its own ``torch.Generator`` on the rank's device, seeded with
:func:`point_seed`, the first 64-bit word of
``np.random.SeedSequence((seed, p, i))``, and that ``sim_step`` takes its
draws from it.  Ranks at different positions draw different streams; a
step at one rank (position 0) equals ``sim_step`` on
``point_generator(seed, 0, i)``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..sim import SimStats, make_decode_fn, matmul_encode_fn, sim_step
from ..utils.config import DecoderConfig
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .mesh import DATA_AXIS, Mesh

__all__ = [
    "SimStats",
    "make_sharded_campaign_step",
    "point_generator",
    "point_seed",
    "sim_step",
]


def point_seed(seed: int, position: int, i: int) -> int:
    """The seed of local point ``i`` at mesh position ``position`` of a
    step seeded ``seed`` (non-negative integers)."""
    words = np.random.SeedSequence((seed, position, i)).generate_state(1, np.uint64)
    return int(words[0])


def point_generator(seed: int, position: int, i: int,
                    device=DEFAULT_DEVICE) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with :func:`point_seed`."""
    return torch.Generator(device=device).manual_seed(point_seed(seed, position, i))


def make_sharded_campaign_step(
    code,
    cfg: DecoderConfig,
    mesh: Mesh,
    batch_per_device: int,
    num_snr: int,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    data_axis: str = DATA_AXIS,
    snr_axis: Optional[str] = None,
    outer: "Optional[tuple]" = None,
    mod=None,
    demap: str = "maxlog",
    id_outer: int = 0,
    *,
    device=DEFAULT_DEVICE,
):
    """Build the sharded campaign step: ``(seed, snr_db[num_snr]) ->
    SimStats`` with a leading SNR axis ``[num_snr]`` (module docstring: the
    layout, the sum and the seed rule).

    The codeword batch is sharded over ``data_axis``; if ``snr_axis`` is a
    mesh axis, the SNR grid is additionally sharded over it (the BASELINE
    config-5 layout).  Total frames simulated per call: ``num_snr *
    batch_per_device * mesh.shape[data_axis]``.  ``encode_fn``,
    ``decode_fn``, ``outer``, ``mod``, ``demap`` and ``id_outer`` go to
    ``sim_step`` as they are; the encoder and the ``Decoder`` default to
    the code's own on ``device`` (this rank's: the card unless
    ``"cpu"``).  Every rank of the group must call the step together: its
    sum is a collective whenever a process group exists.
    """
    snr_axis = snr_axis if snr_axis and snr_axis in mesh.axis_names else None
    n_snr_shards = mesh.shape[snr_axis] if snr_axis else 1
    if num_snr % n_snr_shards:
        raise ValueError(
            f"num_snr={num_snr} not divisible by snr mesh axis {n_snr_shards}"
        )
    if data_axis not in mesh.axis_names:
        raise ValueError(f"data axis {data_axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")
    device = resolve_device(device)
    if encode_fn is None:
        encode_fn = matmul_encode_fn(code, device=device)
    if decode_fn is None:
        decode_fn = make_decode_fn(code, cfg, device=device)
    n_local = num_snr // n_snr_shards
    coords = mesh.coords
    position = first = 0
    fills = False
    if coords is not None:
        s = coords[snr_axis] if snr_axis else 0
        position = coords[data_axis] * n_snr_shards + s
        first = s * n_local
        # one copy along the axes that are neither summed nor split
        fills = all(c == 0 for a, c in coords.items() if a not in (data_axis, snr_axis))

    def step(seed: int, snr_db) -> SimStats:
        snrs = [float(x) for x in snr_db]
        if len(snrs) != num_snr:
            raise ValueError(f"the step takes {num_snr} SNR points, got {len(snrs)}")
        out = torch.zeros((len(SimStats._fields), num_snr), dtype=torch.int64,
                          device=device)
        if coords is not None:
            for i in range(n_local):
                stats = sim_step(
                    code, cfg, point_generator(seed, position, i, device),
                    snrs[first + i], batch_per_device, encode_fn, decode_fn,
                    mod=mod, demap=demap, id_outer=id_outer, outer=outer)
                if fills:
                    out[:, first + i] = torch.stack(tuple(stats))
        if dist.is_initialized():
            dist.all_reduce(out)
        return SimStats(*out)

    return step
