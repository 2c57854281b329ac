"""BER/FER waterfall campaigns with checkpoint/resume.

NumPy copy of ``myldpccppapi_tpu/campaign/waterfall.py``: the same stopping
rules, per-(point, step) seeds, grouped stepping, checkpoint JSON and
CSV/JSON reports, so a campaign behaves the same in both packages for the
same step function.  One addition for multi-process campaigns: every rank
runs the campaign in lockstep on the same summed statistics, so its stop
decisions agree on every rank, and only rank 0 writes the checkpoint
(every rank loads it).

The reference's only "campaign" machinery is a single CLI roundtrip with a
printed error count (``Test.cpp:105-112``).  This module provides what
SURVEY.md §5 calls for: resumable Monte-Carlo waterfall sweeps — per-SNR
frame/bit-error accumulators (exact integers), early stopping at a target
frame-error count, JSON checkpointing so long multi-host campaigns survive
restarts, and structured metric emission (BER/FER with confidence intervals,
iterations-to-convergence, decoded Mbit/s).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["PointStats", "CampaignConfig", "WaterfallCampaign"]


@dataclasses.dataclass
class PointStats:
    """Exact accumulated statistics for one SNR point."""

    snr_db: float
    frames: int = 0
    frame_errors: int = 0
    bit_errors: int = 0
    info_bits: int = 0
    iterations: int = 0
    unconverged: int = 0
    #: frames accepted (syndrome, and CRC under CRC-aided acceptance) yet
    #: wrong — errors the receiver cannot see
    undetected_errors: int = 0
    #: wrong-codeword convergences caught by the CRC (0 without cfg.crc)
    crc_rejected: int = 0
    wall_s: float = 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else math.nan

    @property
    def ber(self) -> float:
        return self.bit_errors / self.info_bits if self.info_bits else math.nan

    @property
    def avg_iters(self) -> float:
        return self.iterations / self.frames if self.frames else math.nan

    @property
    def detected_errors(self) -> int:
        """Frame errors the receiver knows about (not accepted)."""
        return self.frame_errors - self.undetected_errors

    def fer_ci95(self) -> float:
        """Half-width of the 95% normal-approx confidence interval on FER."""
        if not self.frames:
            return math.nan
        p = self.fer
        return 1.96 * math.sqrt(max(p * (1 - p), 1e-300) / self.frames)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(fer=self.fer, ber=self.ber, avg_iters=self.avg_iters,
                 detected_errors=self.detected_errors)
        return d


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Stopping criteria + reproducibility for a waterfall sweep."""

    snr_db: Sequence[float]
    batch_per_step: int = 1024
    min_frame_errors: int = 100   # stop a point once it has this many errors
    max_frames: int = 1_000_000   # ... or this many frames, whichever first
    seed: int = 0

    def fingerprint(self, code_name: str, decoder_repr: str) -> str:
        key = json.dumps(
            [list(map(float, self.snr_db)), self.batch_per_step, self.seed,
             code_name, decoder_repr],
            sort_keys=True,
        )
        import hashlib

        return hashlib.sha256(key.encode()).hexdigest()[:16]


class WaterfallCampaign:
    """Drive a (code, decoder-config) pair through an SNR sweep.

    ``step_fn(key_seed: int, snr_db: float) -> SimStats-like`` is any callable
    returning per-batch integer stats that ``np.asarray`` reads (host
    values) — e.g. the sharded campaign step (parallel/sim.py), its counts
    moved to the host.  The campaign owns only the host-side
    accumulation, stopping, checkpointing, and reporting.  ``rank`` is
    this process's rank in a multi-process campaign: only rank 0 writes
    the checkpoint.
    """

    def __init__(
        self,
        config: CampaignConfig,
        step_fn,
        frames_per_step: int,
        fingerprint: str = "",
        checkpoint_path: Optional[str] = None,
        snr_group_size: int = 1,
        rank: int = 0,
    ):
        self.config = config
        self.step_fn = step_fn
        #: expected frames per point per step; used to validate the step
        #: function's actual output (a mismatch means the caller's batch
        #: arithmetic disagrees with what the step simulates)
        self.frames_per_step = frames_per_step
        self.fingerprint = fingerprint
        self.checkpoint_path = checkpoint_path
        #: >1 = SNR points are simulated in fixed groups of this size per
        #: step (one per snr-mesh shard, the BASELINE config-5 layout);
        #: ``step_fn(seed, [snr...])`` must then return stats with a
        #: leading [group] axis.  A finished point keeps simulating as
        #: filler until its whole group stops (its results are discarded).
        self.snr_group_size = max(1, int(snr_group_size))
        self.rank = rank
        self.points: List[PointStats] = [PointStats(float(s)) for s in config.snr_db]
        self.steps_done: List[int] = [0] * len(self.points)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.load(checkpoint_path)

    # -- persistence -------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        path = path or self.checkpoint_path
        if not path or self.rank != 0:
            return
        state = {
            "fingerprint": self.fingerprint,
            "steps_done": self.steps_done,
            "points": [dataclasses.asdict(p) for p in self.points],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        with open(path) as f:
            state = json.load(f)
        if state.get("fingerprint") != self.fingerprint:
            return False  # different campaign; start fresh
        self.steps_done = list(state["steps_done"])
        self.points = [PointStats(**p) for p in state["points"]]
        return True

    # -- execution ---------------------------------------------------------
    def point_finished(self, i: int) -> bool:
        p = self.points[i]
        return (
            p.frame_errors >= self.config.min_frame_errors
            or p.frames >= self.config.max_frames
        )

    @property
    def finished(self) -> bool:
        return all(self.point_finished(i) for i in range(len(self.points)))

    def _accumulate(self, i: int, stats, wall_s: float, take=None) -> None:
        """Add one step's stats into point i.  ``take`` selects the point's
        slice of a grouped [S]-leading stats tuple (None = whole thing)."""
        p = self.points[i]

        def tot(x):
            a = np.asarray(x)
            if take is None or a.ndim == 0:  # scalar defaults have no axis
                return int(np.sum(a))
            return int(np.sum(a[take]))

        frames = tot(stats.frames)
        if self.frames_per_step and frames != self.frames_per_step:
            raise ValueError(
                f"step_fn simulated {frames} frames for point {i} but the "
                f"campaign was constructed with frames_per_step="
                f"{self.frames_per_step}: the caller's batch/mesh "
                "arithmetic disagrees with the step function"
            )
        p.wall_s += wall_s
        p.frames += tot(stats.frames)
        p.frame_errors += tot(stats.frame_errors)
        p.bit_errors += tot(stats.bit_errors)
        p.info_bits += tot(stats.info_bits)
        p.iterations += tot(stats.iterations)
        p.unconverged += tot(stats.unconverged)
        # optional split fields (older step_fn fakes may omit them)
        p.undetected_errors += tot(getattr(stats, "undetected_errors", 0))
        p.crc_rejected += tot(getattr(stats, "crc_rejected", 0))
        self.steps_done[i] += 1

    def run(self, checkpoint_every: int = 10, progress=None) -> List[PointStats]:
        """Round-robin the unfinished SNR points until all stop criteria hit."""
        if self.snr_group_size > 1:
            return self._run_grouped(checkpoint_every, progress)
        steps_since_ckpt = 0
        while not self.finished:
            for i, p in enumerate(self.points):
                if self.point_finished(i):
                    continue
                # derive a unique, resumable seed per (point, step)
                seed = (
                    self.config.seed * 1_000_003 + i * 7919 + self.steps_done[i]
                )
                t0 = time.perf_counter()
                stats = self.step_fn(seed, p.snr_db)
                self._accumulate(i, stats, time.perf_counter() - t0)
                steps_since_ckpt += 1
                if progress:
                    progress(i, p)
                if steps_since_ckpt >= checkpoint_every:
                    self.save()
                    steps_since_ckpt = 0
        self.save()
        return self.points

    def _run_grouped(self, checkpoint_every: int, progress) -> List[PointStats]:
        """Grouped stepping: every step simulates ``snr_group_size`` SNR
        points at once (one per snr-mesh shard); a group keeps stepping
        until ALL its points hit their stop criteria (finished members run
        as filler, their extra stats discarded so resume points stay
        deterministic)."""
        gs = self.snr_group_size
        groups = [list(range(g, min(g + gs, len(self.points))))
                  for g in range(0, len(self.points), gs)]
        steps_since_ckpt = 0
        while not self.finished:
            for gi, grp in enumerate(groups):
                if all(self.point_finished(i) for i in grp):
                    continue
                seed = (
                    self.config.seed * 1_000_003 + gi * 7919
                    + self.steps_done[grp[0]]
                )
                # pad short tail groups by repeating the last point
                snrs = [self.points[i].snr_db for i in grp]
                snrs += [snrs[-1]] * (gs - len(grp))
                t0 = time.perf_counter()
                stats = self.step_fn(seed, snrs)
                wall = time.perf_counter() - t0
                # charge wall time to the points still doing useful work
                # (finished members run as discarded filler)
                active = [i for i in grp if not self.point_finished(i)]
                for pos, i in enumerate(grp):
                    if i not in active:
                        self.steps_done[i] += 1  # keep group seeds aligned
                        continue
                    self._accumulate(i, stats, wall / len(active), take=pos)
                    if progress:
                        progress(i, self.points[i])
                steps_since_ckpt += 1
                if steps_since_ckpt >= checkpoint_every:
                    self.save()
                    steps_since_ckpt = 0
        self.save()
        return self.points

    # -- reporting ---------------------------------------------------------
    def report(self) -> Dict:
        rows = [p.as_dict() for p in self.points]
        return {"fingerprint": self.fingerprint, "points": rows}

    def write_csv(self, path: str) -> None:
        cols = [
            "snr_db", "frames", "frame_errors", "bit_errors", "info_bits",
            "iterations", "unconverged", "detected_errors",
            "undetected_errors", "crc_rejected", "fer", "ber", "avg_iters",
            "wall_s",
        ]
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for p in self.points:
                d = p.as_dict()
                f.write(",".join(str(d[c]) for c in cols) + "\n")
