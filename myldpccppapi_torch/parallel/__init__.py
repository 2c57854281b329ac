"""Multi-process campaigns: a mesh over the ranks of a ``torch.distributed``
process group, the sharded campaign step with its statistics summed by a
collective, and the launchers (counterpart of ``myldpccppapi_tpu/parallel``;
``dryrun.py`` holds the counterpart of ``__graft_entry__.dryrun_multichip``).
"""
from .dist import World, init_from_env, shutdown, spawn
from .mesh import DATA_AXIS, SNR_AXIS, Mesh, make_mesh
from .sim import SimStats, make_sharded_campaign_step, point_generator, sim_step

__all__ = [
    "DATA_AXIS",
    "SNR_AXIS",
    "Mesh",
    "SimStats",
    "World",
    "init_from_env",
    "make_mesh",
    "make_sharded_campaign_step",
    "point_generator",
    "shutdown",
    "sim_step",
    "spawn",
]
