"""Host side of the global-posterior kernel (``csrc/bp_stream.cu``, the
port of ``myldpccppapi_tpu/ops/pallas_stream.py``'s kernel D): its stage
plan, its compressed min-sum messages, its tables and its launch's
:class:`Plan`, which ``ops/cuda_long.py`` resolves in the global placement.
Its plain version is the long-code kernel's, ``decode_qc_long_plain``.

**The stage plan** (:func:`stage_plan`).  The kernel brings each layer's
distinct block columns of the posterior into a ring of two shared-memory
stages, starting the bulk copies of layer g + 1 at the start of layer g
(its prefetch distance, :data:`DISTANCE`, is one layer).  A copy started
then sees every write-back of layers up to g - 1, so a (layer, column)
cell whose column was last updated (cyclically: across the sweep boundary
too) more than ``distance`` layers earlier is LOADED from device memory;
one updated within ``distance`` layers is FORWARDED: the layer that
updates it writes the new values straight into this layer's stage.  Every
update is also written through to device memory, so every column ends
each sweep written back.  This is kernel D's ``safe`` table
(``pallas_stream.py:99-113``).  The plan is made for any distance, so the
tests can replay its schedule further ahead; the kernel's tables take
distance 1 only.

**The compressed messages** (:func:`compress_min_sum`,
:func:`expand_min_sum`).  Under min-sum a check row's messages are
determined by m1s and m2s (alpha/beta applied, rounded to the message
type), the first edge whose |q| equals m1, and one sign bit per edge; the
kernel stores that record instead of the row's per-edge messages.  The
two functions are the record's encoder and decoder in torch, bit-exact
with the per-edge messages of ``ops/bp.py``'s check update.

**Persistent blocks and turns** (:func:`turn_sweeps`, :func:`queue_entries`,
:func:`workspace`).  The kernel's grid is ``min(batch, slots)`` blocks, the
blocks the device holds at once.  A block takes a ticket from a device-side
FIFO, runs at most :data:`TURN_SWEEPS` sweeps of the ticket's codeword from
its saved sweep count, and puts an unfinished codeword back at the queue's
tail; P, R, the sweep count, the iterations and the latch (the
``executed``, ``iterations`` and ``converged`` outputs) live in device
memory between turns, so a codeword resumes on any block.  This ends the
in-order grid's tail on an emptying card.  Turns engage only when the batch
exceeds the slots.  The queue is a workspace per device and stream that the
kernel's last block returns to zeros.  :func:`turn_sweeps` mirrors the
library's rule for the CPU tests.

**The phase counter** (:func:`phase_counter`, :func:`phase_cycles`).
While a torch profiler records (``utils.profiling.recording``), a min-sum
launch passes its device's counter and the library runs the kernel's
clocked instantiation (:data:`PHASE_SLOTS`); otherwise the launch passes
null and runs the unclocked kernel.  Sum-product always runs unclocked.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig
from ..utils.profiling import recording
from . import _build, cuda_launch
from .bp import layer_weights, msg_dtype
from .cuda_launch import dev, group_slots, layer_flags, live_rows, mask_slots, n_masks

__all__ = ["DISTANCE", "PHASES", "PHASE_SLOTS", "Plan", "QUEUE_COUNTERS", "StagePlan",
           "TURN_SWEEPS", "blocks_per_sm", "compress_min_sum", "expand_min_sum", "pad_z",
           "phase_counter", "phase_cycles", "plan", "queue_entries", "record_words",
           "stage_plan", "stream_bytes", "turn_sweeps", "workspace"]

#: the kernel's prefetch distance in layers (its ring holds two stages)
DISTANCE = 1
#: the index field of a record (the first edge at m1): the low bits of its
#: first meta word; the sign of edge k is meta bit IDX_BITS + k
IDX_BITS = 6
_INF = 1e30
#: field positions of the kernel's table words (csrc/bp_stream.cu)
_SLOT_SHIFT, _MASK_SHIFT = 14, 20
_LOAD_BIT, _FWD_SLOT_SHIFT, _FWD_BIT = 16, 17, 23
#: the clocked kernel's phases, in the order of its counter
PHASES = ("stage", "pass1", "pass2", "sweep_end")
#: the counter's slots: each phase's cycles, then the blocks' resident
#: cycles (each turn, from taking it to its end), sweeps and turns, each
#: summed over the blocks
PHASE_SLOTS = PHASES + ("resident", "sweeps", "turns")
#: each device's phase counter, int64 [len(PHASE_SLOTS)]
_phase_counters: dict = {}
#: the kernel's turn (its kTurnSweeps): the most sweeps a turn runs when
#: turns engage
TURN_SWEEPS = 4
#: the queue workspace's counters (head, tail, finished, left) before its
#: entries
QUEUE_COUNTERS = 4
#: each (device, stream)'s turn queue workspace, int32
_workspaces: dict = {}


def pad_z(z: int) -> int:
    """A block column's length in the kernel's global and staged layouts: z
    rounded up to 8 values, so that a column is a whole number of 16-byte
    units in f32 and bf16 alike."""
    return (z + 7) // 8 * 8


def record_words(max_row_degree: int, itemsize: int) -> int:
    """32-bit words of a min-sum record: m1s and m2s (two f32 or two packed
    bf16), then the index and sign bits."""
    return (2 if itemsize == 4 else 1) + (IDX_BITS + max_row_degree + 31) // 32


@dataclasses.dataclass(frozen=True, eq=False)
class StagePlan:
    """Where each (layer, column) cell of a sweep comes from.  The cells of
    layer i are ``col_ptr[i]:col_ptr[i + 1]``, in the order of their first
    circulant; cell c is block column ``cols[c]``, whose previous use lies
    ``back[c]`` layers earlier (cyclically; ``m_b`` when no other layer uses
    it); it is ``loaded`` from device memory when that is more than
    ``distance``, else forwarded by its writer, except in the decode's
    first sweep, where a cell whose writer would come before the decode's
    first layer is loaded (the LLRs).  After its layer's update cell c is
    forwarded to slot ``fwd_slot[c]`` of the layer ``fwd_dist[c]`` ahead
    (0: to none).  ``edge_slot[e]`` is block e's cell within its layer."""

    distance: int
    col_ptr: np.ndarray
    cols: np.ndarray
    back: np.ndarray
    loaded: np.ndarray
    fwd_dist: np.ndarray
    fwd_slot: np.ndarray
    edge_slot: np.ndarray

    @property
    def total_cols(self) -> int:
        return len(self.cols)

    @property
    def max_cols(self) -> int:
        return int(np.diff(self.col_ptr).max())

    @property
    def record_forwarded(self) -> bool:
        """A layer's own record comes back within the ring (m_b <= distance):
        the kernel forwards it as it forwards columns."""
        return len(self.col_ptr) - 1 <= self.distance


@functools.lru_cache(maxsize=64)
def stage_plan(code: QCCode, distance: int = DISTANCE) -> StagePlan:
    """The stage plan of ``code`` at prefetch distance ``distance``."""
    if distance < 1:
        raise ValueError(f"the prefetch distance must be at least 1, got {distance}")
    _, bc, _ = code.blocks
    ptr = code.layer_ptr
    m_b = code.m_b
    edge_slot = np.empty(code.num_blocks, dtype=np.int32)
    layer_cols = []
    users: dict[int, list[int]] = {}
    for i in range(m_b):
        slots: dict[int, int] = {}
        for e in range(int(ptr[i]), int(ptr[i + 1])):
            edge_slot[e] = slots.setdefault(int(bc[e]), len(slots))
        layer_cols.append(list(slots))
        for c in slots:
            users.setdefault(c, []).append(i)
    col_ptr = np.zeros(m_b + 1, dtype=np.int32)
    col_ptr[1:] = np.cumsum([len(c) for c in layer_cols])
    cols = np.concatenate([np.asarray(c, dtype=np.int32) for c in layer_cols])
    back = np.zeros(len(cols), dtype=np.int32)
    loaded = np.ones(len(cols), dtype=bool)
    fwd_dist = np.zeros(len(cols), dtype=np.int32)
    fwd_slot = np.zeros(len(cols), dtype=np.int32)
    for i, layer in enumerate(layer_cols):
        for k, c in enumerate(layer):
            uses = users[c]
            prev = uses[uses.index(i) - 1]  # cyclic: the last use of the sweep
            d = (i - prev) % m_b or m_b
            back[col_ptr[i] + k] = d
            if d <= distance:
                loaded[col_ptr[i] + k] = False
                writer = col_ptr[prev] + layer_cols[prev].index(c)
                fwd_dist[writer] = d
                fwd_slot[writer] = k
    return StagePlan(distance, col_ptr, cols, back, loaded, fwd_dist, fwd_slot, edge_slot)


def stream_bytes(code: QCCode, itemsize: int = 4, sum_product: bool = False) -> dict:
    """Device-memory bytes one codeword's sweep (after the first) moves in
    the kernel's plan: P loaded (whole padded columns) and written (z values
    per cell), R read and written (records, or under sum-product z messages
    per edge).  The exact syndrome's reads (each variable once) are not
    counted."""
    plan = stage_plan(code)
    zp = pad_z(code.z)
    if sum_product:
        r_read = r = code.num_edges * itemsize
    else:
        r = code.m_b * record_words(code.max_row_degree, itemsize) * zp * 4
        r_read = 0 if plan.record_forwarded else r
    return {"p_loaded": int(plan.loaded.sum()) * zp * itemsize,
            "p_written": plan.total_cols * code.z * itemsize,
            "r_read": r_read, "r_written": r}


def compress_min_sum(q: torch.Tensor, alpha: float, beta: float, dtype: torch.dtype,
                     max_row_degree: int) -> torch.Tensor:
    """The records of a layer's rows from their q = P - r_old ([deg, z, B]
    f32, masked rows already at 1e30): [words, z, B] int32 as the kernel
    stores them (``record_words(max_row_degree, itemsize)`` words; word w of
    row r at [w, r]).  m1 and m2 are the least and the second least |q|
    (1e30 at most, as the kernel's running minimum starts there), m1s =
    alpha * max(m1 - beta, 0) and m2s alike rounded to ``dtype``; the index
    is the first edge with |q| == m1 (none: index 0 and m2s = m1s); the
    sign bit of edge k is the parity of the row's negative q XOR q_k < 0."""
    deg = q.shape[0]
    a = q.abs()
    pad = torch.full((2,) + a.shape[1:], _INF, dtype=torch.float32, device=q.device)
    least = torch.cat([a, pad]).sort(dim=0).values
    m1, m2 = least[0], least[1]
    at_m1 = a == m1
    found = at_m1.any(dim=0)
    idx = torch.where(found, at_m1.to(torch.int64).argmax(dim=0), 0)
    m1s = alpha * torch.clamp(m1 - beta, min=0.0)
    m2s = torch.where(found, alpha * torch.clamp(m2 - beta, min=0.0), m1s)
    m1t, m2t = m1s.to(dtype), m2s.to(dtype)
    neg = (q < 0).to(torch.int64)
    sign = (neg.sum(dim=0) & 1) ^ neg
    words = []
    if dtype == torch.float32:
        words += [m1t.view(torch.int32).to(torch.int64), m2t.view(torch.int32).to(torch.int64)]
    else:
        half = [x.view(torch.int16).to(torch.int64) & 0xFFFF for x in (m1t, m2t)]
        words.append(half[0] | (half[1] << 16))
    for w in range((IDX_BITS + max_row_degree + 31) // 32):
        acc = idx.clone() if w == 0 else torch.zeros_like(idx)
        for k in range(deg):
            bit = IDX_BITS + k
            if bit >> 5 == w:
                acc |= sign[k] << (bit & 31)
        words.append(acc)
    out = torch.stack(words)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def expand_min_sum(words: torch.Tensor, deg: int, dtype: torch.dtype,
                   live: "torch.Tensor | None" = None) -> torch.Tensor:
    """A layer's per-edge messages [deg, z, B] in ``dtype`` from its records
    ([words, z, B] int32): edge k gets sign_k ? -mag : mag with mag = m2s
    on the record's index edge and m1s elsewhere; 0 where ``live`` ([deg, z,
    1] bool, None = every row) marks a masked row."""
    if dtype == torch.float32:
        m1, m2 = words[0].view(torch.float32), words[1].view(torch.float32)
        meta = words[2:]
    else:
        def half(x):
            return (((x & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)
        m1, m2 = half(words[0]), half(words[0] >> 16)
        meta = words[1:]
    idx = meta[0] & ((1 << IDX_BITS) - 1)
    out = []
    for k in range(deg):
        bit = IDX_BITS + k
        neg = ((meta[bit >> 5] >> (bit & 31)) & 1) == 1
        mag = torch.where(idx == k, m2, m1)
        out.append(torch.where(neg, -mag, mag))
    out = torch.stack(out)
    if live is not None:
        out = torch.where(live, out, out.new_zeros(()))
    return out


def _table_words(code: QCCode, plan: StagePlan) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's shift words (shift | cell slot << 14 | mask slot << 20)
    and column words (column | loaded << 16 | forward slot << 17 |
    forwarded << 23) of a plan at distance 1."""
    _, _, sh = code.blocks
    shift = (sh.astype(np.int64) | plan.edge_slot.astype(np.int64) << _SLOT_SHIFT
             | mask_slots(code) << _MASK_SHIFT)
    if plan.distance != DISTANCE:
        raise ValueError(f"the kernel runs at prefetch distance {DISTANCE}, "
                         f"not {plan.distance}")
    if (code.z > 1 << _SLOT_SHIFT or plan.max_cols > 64 or n_masks(code) >= 1 << 12
            or code.n_b > 1 << _LOAD_BIT):
        raise ValueError(f"{code.name} passes the global kernel's table fields")
    col = (plan.cols.astype(np.int64) | plan.loaded.astype(np.int64) << _LOAD_BIT
           | plan.fwd_slot.astype(np.int64) << _FWD_SLOT_SHIFT
           | (plan.fwd_dist > 0).astype(np.int64) << _FWD_BIT)
    wrap = lambda x: np.where(x >= 2**31, x - 2**32, x).astype(np.int32)  # noqa: E731
    return wrap(shift), col.astype(np.int32)


def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """The kernel's tables on ``device`` (a plan's tables): shift words,
    layer pointers, layer flags, column pointers, column words, the masked
    blocks' live-row bits, alpha and beta."""
    plan = stage_plan(code)
    shift, col = _table_words(code, plan)
    alphas, betas = layer_weights(normalization, offset, code.m_b)
    return (*(dev(a, np.int32, device) for a in (shift, code.layer_ptr, layer_flags(code),
                                                  plan.col_ptr, col, live_rows(code))),
            dev(alphas, np.float32, device), dev(betas, np.float32, device))


def blocks_per_sm(code: QCCode, sum_product: bool, itemsize: int) -> int:
    """Thread blocks of the kernel that one SM of the current device holds at
    once for ``code``."""
    plan = stage_plan(code)
    got = _build.load().ldpc_bp_stream_blocks_per_sm(
        code.n_b, code.z, code.m_b, code.num_blocks, plan.total_cols, plan.max_cols,
        n_masks(code), group_slots(code), code.max_row_degree, int(sum_product), itemsize)
    if got < 1:
        raise RuntimeError(f"bp_stream occupancy query returned {got}")
    return got


def queue_entries(batch: int, max_iters: int) -> int:
    """Entries of the turn queue that a batch's turns need: every turn of a
    codeword but its first (the library's ``queue_entries``)."""
    if max_iters <= TURN_SWEEPS:
        return 0
    return batch * (-(-max_iters // TURN_SWEEPS) - 1)


def turn_sweeps(batch: int, slots: int, max_iters: int) -> int:
    """The most sweeps a turn runs, as the library's launcher decides it for
    ``batch`` codewords on a device that holds ``slots`` blocks at once:
    :data:`TURN_SWEEPS` when the batch exceeds the slots, else ``max_iters``
    (one turn a codeword)."""
    return TURN_SWEEPS if batch > slots and max_iters > TURN_SWEEPS else max_iters


def workspace(device, stream: int, entries: int) -> torch.Tensor:
    """The turn queue's workspace of ``device`` and ``stream`` (int32
    [QUEUE_COUNTERS + entries] at least, zeros when made): made at its first
    use, and made anew, larger, when a launch needs more entries.  The
    kernel leaves it zeros, so the launches of one stream share it; another
    stream gets its own."""
    key = (torch.device(device), stream)
    work = _workspaces.get(key)
    if work is None or work.numel() < QUEUE_COUNTERS + entries:
        work = _workspaces[key] = torch.zeros(QUEUE_COUNTERS + entries, dtype=torch.int32,
                                              device=key[0])
    return work


def phase_counter(device) -> torch.Tensor:
    """``device``'s phase counter (int64 [len(PHASE_SLOTS)], zeros when
    made): made at its first use, then kept for the process."""
    dev = torch.device(device)
    counter = _phase_counters.get(dev)
    if counter is None:
        counter = _phase_counters[dev] = torch.zeros(len(PHASE_SLOTS), dtype=torch.int64,
                                                     device=dev)
    return counter


def phase_cycles() -> "dict | None":
    """What the phase counters hold, summed over the devices: {slot of
    :data:`PHASE_SLOTS`: int}; None while no counter exists.  Reading waits
    for each device's queued work."""
    if not _phase_counters:
        return None
    total = sum(c.cpu() for c in _phase_counters.values())
    return dict(zip(PHASE_SLOTS, total.tolist()))


@dataclasses.dataclass(frozen=True, eq=False)
class Plan(cuda_launch.Plan):
    """Kernel D's launches (:func:`plan`): ``ints``, ``ldpc_bp_stream``'s
    integer arguments after the batch; ``r_shape``, a codeword's R scratch
    (records, or under sum-product messages per block)."""

    kind, entry = "long", "ldpc_bp_stream"
    device_tables = staticmethod(_device_tables)

    ints: tuple
    r_shape: tuple

    def args(self, outs, llr_k, tile, stream) -> tuple:
        """Allocates P and R.  After the stream: the phase counter while a
        profiler records min-sum (else None), the turn queue and its entries."""
        batch, device = llr_k.shape[0], llr_k.device
        sum_product = self.cfg.algorithm == "sum-product"
        # uninitialised: the kernel copies the LLRs into P and reads no R in
        # sweep 0
        p_scratch = torch.empty((batch, self.code.n_b, pad_z(self.code.z)), dtype=llr_k.dtype,
                                device=device)
        r_scratch = torch.empty((batch, *self.r_shape),
                                dtype=llr_k.dtype if sum_product else torch.int32, device=device)
        entries = queue_entries(batch, self.cfg.max_iters)
        return (*outs, r_scratch.data_ptr(), p_scratch.data_ptr(),
                *(t.data_ptr() for t in self.tables), batch, *self.ints, stream,
                phase_counter(device).data_ptr() if recording() and not sum_product else None,
                workspace(device, stream, entries).data_ptr(), entries)


def plan(code: QCCode, cfg: DecoderConfig, device, counter, counts: tuple) -> Plan:
    """Kernel D's plan, whose launches bump ``counts`` on ``counter``
    (``cuda_long.plan`` checks the request and caches it)."""
    stages = stage_plan(code)
    sum_product = cfg.algorithm == "sum-product"
    item = msg_dtype(cfg).itemsize
    r_shape = ((code.num_blocks, pad_z(code.z)) if sum_product else
               (code.m_b, record_words(code.max_row_degree, item), pad_z(code.z)))
    return Plan(code, cfg, device, counter, counts,
                (code.n_b, code.z, code.m_b, code.num_blocks, stages.total_cols,
                 stages.max_cols, n_masks(code), group_slots(code), code.max_row_degree,
                 cfg.max_iters, int(cfg.early_exit), int(cfg.syndrome_mode == "lazy"),
                 int(sum_product), int(cfg.msg_dtype == "bfloat16")),
                r_shape)
