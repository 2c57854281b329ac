"""A logical mesh over the ranks of the process group.

Counterpart of ``myldpccppapi_tpu/parallel/mesh.py``.  The reference lays
a ``jax.sharding.Mesh`` over devices, driven by one process; the port runs
one process per rank (``dist.py``), so a mesh here is laid over the ranks
of the default process group, row-major as the reference reshapes its
device list: rank r sits at ``np.unravel_index(r, shape)``.
:func:`make_mesh` gives this rank's coordinate on each axis and each
axis's size; the campaign step (``sim.py``) reads them to pick its share
of the SNR grid and its noise streams, and sums over the ``"data"`` axis
with a collective.

Axis conventions used throughout the framework:

* ``"data"`` — codeword-batch sharding (the reference's NDRange dim 0).
* ``"snr"``  — SNR-sweep points of a waterfall campaign (optional axis).

The reference's ``data_sharding`` and ``replicated`` return
``NamedSharding``s, which have no PyTorch object: a rank holds its own
batch, and every rank holds the summed statistics, so the port has no
counterpart of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["DATA_AXIS", "SNR_AXIS", "Mesh", "make_mesh"]

DATA_AXIS = "data"
SNR_AXIS = "snr"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axes of the given sizes over ranks ``0 .. size - 1`` of the
    process group, seen from ``rank``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size, by name (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> Optional[Dict[str, int]]:
        """This rank's coordinate on each axis; None for a rank past the
        mesh (a mesh smaller than the world, as the reference's
        ``devices[:n]``)."""
        if self.rank >= self.size:
            return None
        at = np.unravel_index(self.rank, self.axis_sizes)
        return {a: int(c) for a, c in zip(self.axis_names, at)}


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
) -> Mesh:
    """Build a mesh over the ranks of the default process group (one rank
    when there is none).

    ``shape=None`` uses all ranks on a single ``"data"`` axis.  A 2-D
    campaign mesh is e.g. ``make_mesh((n_snr, n_data), ("snr", "data"))``.
    """
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names "
                         f"{tuple(axis_names)} {len(axis_names)}")
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {world}")
    return Mesh(tuple(axis_names), shape, rank)
