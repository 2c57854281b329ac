#!/usr/bin/env python3
"""Phase 4p of ``chip_smoke.py`` on a machine with several cards, one rank
each (the multi-process campaign's path across cards):

    python3 chip_multicard.py            # needs 4 cards

1. ``chip_smoke.phase_nccl_world1``: the sharded step on an NCCL world of
   1 on cuda:0 equal to ``sim_step``, and BASELINE config 5's campaigns at
   world 1 (the baseline).
2. ``chip_smoke.phase_multichip_ranks`` under the default backend (NCCL:
   each rank has a card of its own): ``dryrun_multichip(4)``'s legs on
   every rank equal to this process's recount, every field.
3. ``chip_smoke.torchrun_waterfall`` for both config-5 families under
   NCCL and under gloo: 4 ranks through ``torch.distributed.run``, each
   with its resume; the two backends' lines must be equal.

Prints the cards' names and power limits first and ``multicard OK`` last;
any failure raises.  Exits 1 with fewer than 4 cards.
"""
import subprocess
import sys
import tempfile
import time


def main() -> int:
    import torch

    import chip_smoke as cs
    from myldpccppapi_torch.ops import _build

    if torch.cuda.device_count() < cs.MP_RANKS:
        print(f"chip_multicard: needs {cs.MP_RANKS} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    t = time.perf_counter()
    _build.build()
    _build.load()
    cs.log(f"[multicard] built in {time.perf_counter() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 encode matmul
    world1 = cs.phase_nccl_world1()
    ranks = cs.phase_multichip_ranks(backend=None)
    cs.log(f"[multicard] spawn + init {ranks['ready_s']:.2f} s (the dry run "
           f"{ranks['spawn_s']:.2f} s); the collective {ranks['collective_ms']} ms per rank")
    for family in cs.C5_FAMILIES:
        runs = {}
        for backend in ("nccl", "gloo"):
            with tempfile.TemporaryDirectory() as tmp:
                runs[backend] = cs.torchrun_waterfall(family, tmp, backend=backend)
        if runs["nccl"]["lines"] != runs["gloo"]["lines"]:
            raise AssertionError(f"{family}: the nccl and gloo campaigns differ")
        cs.log(f"[multicard] {family}: world 1 {world1[family]['frames_per_s']:.1f} "
               f"frames/s, {world1[family]['steady_frames_per_s']:.1f} past the first "
               "group; " + "; ".join(
                   f"{b} {runs[b]['frames_per_s']:.1f} frames/s, "
                   f"{runs[b]['steady_frames_per_s']:.1f} past the first group"
                   for b in runs) + "; nccl == gloo, every line")
    cs.log("multicard OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
