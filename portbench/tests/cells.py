"""Cells for the tests: the real ones by name, and the same cells cut to a
size the CPU decodes in a moment (the short DVB-S2 frame, a batch of 8, 2
sets), the program on its torch path."""
from __future__ import annotations

import copy
import hashlib

from portbench.spec import HERE, load_cell

RECEIVE = ("dvbs2_64800_r12.gateway",)
#: the short frame's table, a test file beside this one
SHORT = HERE / "tests" / "dvbs2_16200_r12.table.txt"


def tiny(name: str = "dvbs2_64800_r12.gateway", **traffic):
    """``name`` on the short frame (n=16200, k=7200) with a batch of 8 and
    2 sets on the CPU, where ``Decoder`` resolves to the torch path and no
    kernel counter moves.  That path checks the exact syndrome whatever
    ``syndrome_mode`` says, so the cut cell states it."""
    cell = copy.deepcopy(load_cell(name))
    cell.config.update(n=16200, k=7200, table=f"../tests/{SHORT.name}",
                       table_sha256=hashlib.sha256(SHORT.read_bytes()).hexdigest())
    cell.config["decoder"] = dict(cell.config["decoder"], syndrome_mode="exact")
    cell.traffic.update(dict(batch=8, sets=2, warmup_s=0.0, check_calls=2,
                             check_within=2, trace_start=2, trace_calls=1), **traffic)
    cell.workload = dict(cell.workload, implementation="torch", counter=None)
    return cell
