"""Wrapper of the hand-written short-code BP kernel (``csrc/bp_layered.cu``).

Counterpart of two TPU kernels of ``myldpccppapi_tpu/ops/pallas_bp.py``,
served as modes and routes of one CUDA kernel:

* ``_build_kernel`` (kernel A) in its f32 and bf16 modes: layered or
  flooding, min-sum (scalar or per-layer alpha/beta) or sum-product, SCMS
  on the flooding min-sum sweep, soft output (the latched posterior) on
  either schedule; on QC circulants and on RS-LDPC's additive blocks (the
  xor group, ``_xor_align``), with multi-edge cells (``extra_blocks``);
* ``_build_kernel_dyn`` (kernel B), the table-driven layered min-sum for
  base graphs of more than 120 circulants: the same kernel, which reads the
  code's structure from runtime tables anyway, gated to B's own domain
  (layered min-sum, scalar alpha/beta, no soft output; bf16 too, as A's
  bf16 sweep is the same sweep) and to codes kernel C does not serve
  (z < 64, the small-z 5G NR codes).

Under bf16 the wrapper casts the LLRs to bf16 on the card and the kernel
keeps its state in bf16, rounding after every operation as kernel A and
the jnp path do; its plain version is the torch path's bf16 decode
(ops/bp.py), which rounds at the same points.

The wrapper decides the launch's shape: :func:`lanes` split each check row,
:func:`tile_size` picks the codewords a thread block from the batch and the
occupancy, and :func:`edges_per_lane` names the instantiation: four edges a
lane (narrow), eight (wide) or five (fitted, 802.11n 1944 r5/6's and
802.16e r5/6's rows of 20 over 4 lanes, three blocks an SM).

:func:`plan` resolves a launch once per (code, config, device), and
``ops/cuda_launch.py`` launches it.  :func:`decode_qc_cuda` launches the
kernel for a CUDA tensor and raises if it cannot (there is no fallback); for
a CPU tensor it runs the plain version, :func:`decode_qc_cuda_plain`.
``decode_qc_cuda.launches`` counts launches in every mode; ``.soft_``,
``.bf16_``, ``.xor_``, ``.multi_edge_`` and ``.fitted_launches`` those with
soft output, bf16 messages, an xor-group code, multi-edge cells and the
fitted instantiation.

**The slot clocks** (:func:`slot_counter`, :func:`slot_clocks`,
:func:`fold_slot_clocks`).  While a torch profiler records
(``utils.profiling.recording``), a launch that has a clocked instantiation
(:func:`clocked`) passes its device and stream's slot counter and its slots
(SMs times the blocks of its tile that one SM holds), and thread 0 of each
block reads ``%globaltimer`` at the block's entry and exit; the counter sums
the slots of :data:`SLOT_CLOCKS` over every clocked launch.  Resident ns
over slot-ns is the share of the card's block slots that the launches kept
busy; syndrome skips over block-sweeps the share of sweeps whose exact
syndrome pass the kernel skipped, because an odd row of the last layer
ruled out every codeword of the block that was not done.  Otherwise the
launch passes null and runs the unclocked kernel.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..codes.rs_ldpc import RSLDPCCode
from ..utils.config import DecoderConfig
from ..utils.device import cuda_index, indexed
from ..utils.profiling import recording
from . import _build, cuda_launch
from .bp import DecodeResult, decode_qc, layer_weights, msg_dtype, weights_mode
from .cuda_launch import MIN_Z, choose_tile, dev, group_slots

__all__ = ["REQUIREMENTS", "SLOT_CLOCKS", "Plan", "choose_tile", "clocked", "decode_qc_cuda",
           "decode_qc_cuda_plain", "edges_per_lane", "fold_slot_clocks", "lanes", "mode",
           "plan", "slot_clocks", "slot_counter", "supported", "tile_size"]

#: the TPU kernels' split (pallas_bp._DYN_BLOCK_THRESHOLD): up to this many
#: circulants kernel A's statically unrolled body, above it kernel B's
#: table-driven one
_MAX_BLOCKS = 120
#: kernel A's cap on an xor-group code's blocks (pallas_bp.supported,
#: ``:131-135``); kernel B's route is cyclic only
_MAX_XOR_BLOCKS = 256
#: mode bits, as csrc/bp_layered.cu reads them
FLOODING, SUM_PRODUCT, SCMS = 1, 2, 4
#: the kernel's edges of a row per lane (its kNarrow, kFitted and kWide
#: instantiations), its widest lane group (kMaxLanes) and row (kMaxDeg)
_NARROW, _FITTED, _WIDE, _MAX_LANES, _MAX_ROW_DEGREE = 4, 5, 8, 16, 64
#: the threads of a narrow instantiation's block (a wide one's: half; a
#: fitted one's: kFittedThreads)
_MAX_THREADS, _FITTED_THREADS = 1024, 384
#: the most threads a codeword's lanes may take before the wrapper takes
#: the wide instantiation (8 edges a lane, half the lanes)
_NARROW_THREADS = 128
#: bit fields of the kernel's tables: an edge word is col * z << 10 |
#: shift; a flooding column-list word block | layer << 9 | position << 20
_SHIFT_BITS, _EDGE_BITS, _LAYER_BITS = 10, 9, 11
#: the slot counter's slots, in the kernel's order (csrc/bp_layered.cu)
SLOT_CLOCKS = ("resident_ns", "slot_ns", "frame_sweeps", "block_sweeps", "blocks",
               "launches", "syndrome_skips")
#: the counter's scratch after them, at its idle values: the launch's first
#: entry (all ones, the identity of its min), last exit and blocks left
_SLOT_SCRATCH = (-1, 0, 0)
#: each (device, stream)'s slot counter, int64 [len(SLOT_CLOCKS) + 3]
_slot_counters: dict = {}
#: what :func:`supported` asks of a code and a config, for error messages
REQUIREMENTS = (
    "an unmasked QCCode or an RSLDPCCode whose codeword state (posterior "
    "and messages, f32 or bf16; the channel too for flooding, the sent "
    "messages too for SCMS, the multi-edge delta table too for layered) "
    "fits a thread block's shared memory; rows of at most "
    f"{_MAX_ROW_DEGREE} circulants; at most "
    f"{_MAX_BLOCKS} circulants (multi-edge cells allowed) or "
    f"{_MAX_XOR_BLOCKS} xor blocks under any schedule and algorithm, with "
    "soft output or not, or more circulants, none multi-edge, with z < "
    f"{MIN_Z} under layered min-sum with scalar alpha/beta and no "
    "soft output (kernel B's domain); scalar or per-layer min-sum weights, "
    "not a per-iteration schedule (the torch path serves that); CRC or "
    "outer-code acceptance wraps it (Decoder)"
)


def mode(cfg: DecoderConfig) -> int:
    """The kernel's mode bits for ``cfg``: FLOODING, SUM_PRODUCT, SCMS."""
    return ((FLOODING if cfg.schedule == "flooding" else 0)
            | (SUM_PRODUCT if cfg.algorithm == "sum-product" else 0)
            | (SCMS if cfg.self_correction else 0))


def _xor(code) -> bool:
    return getattr(code, "group", "cyclic") == "xor"


@functools.lru_cache(maxsize=64)
def cell_table(code) -> np.ndarray:
    """The kernel's multi-edge cell table, int32 [num_blocks + m_b]: for
    each block, its row of the layered delta table if it shares its column
    with another block of its layer (a multi-edge cell; rows numbered in
    block order within the layer), else -1; then each layer's count of
    such rows (0: the layer writes back in place)."""
    _, bc, _ = code.blocks
    ptr = code.layer_ptr
    slot = np.full(code.num_blocks, -1, dtype=np.int32)
    rows = np.zeros(code.m_b, dtype=np.int32)
    for i in range(code.m_b):
        col = bc[ptr[i]:ptr[i + 1]]
        _, inverse, counts = np.unique(col, return_inverse=True, return_counts=True)
        grouped = counts[inverse] > 1
        rows[i] = grouped.sum()
        slot[ptr[i]:ptr[i + 1]][grouped] = np.arange(rows[i])
    return np.concatenate([slot, rows])


def _pow2_lanes(max_row_degree: int, per_lane: int) -> int:
    return 1 << max(0, -(-max_row_degree // per_lane) - 1).bit_length()


def lanes(code) -> int:
    """The lanes that split each check row of ``code`` in the kernel: the
    least power of two that leaves a lane at most four edges of the widest
    row (the narrow instantiation: wimax 576 r3/4B's rows of 15, 4 lanes),
    unless that takes a codeword past 128 threads (z times the lanes); then
    at most eight (the wide one, half the lanes: RS-LDPC's rows of 32 at z
    = 64, 4 lanes; wifi 1944's rows of 20 at z = 81, 4).  Measured on an
    H100 (PERF.md), the narrow lanes give the shortest lone sweep and
    the wide ones hold more codewords an SM.  0 for rows past 64."""
    if code.max_row_degree > _MAX_ROW_DEGREE:
        return 0
    narrow = _pow2_lanes(code.max_row_degree, _NARROW)
    if code.z * narrow <= _NARROW_THREADS:
        return narrow
    return _pow2_lanes(code.max_row_degree, _WIDE)


@functools.lru_cache(maxsize=256)
def edges_per_lane(code, mode_bits: int = 0, tile: int = 1) -> int:
    """The edges a lane of the kernel's instantiation that serves a launch
    of ``code`` in ``mode_bits`` (:func:`mode`; 0 = layered min-sum) with
    ``tile`` codewords a block (csrc/bp_layered.cu's ``edges_per_lane``):
    4 (narrow) where :func:`lanes` leaves a lane at most four edges of the
    widest row; else 5 (fitted) for layered min-sum on a cyclic code without
    multi-edge cells whose widest row leaves a lane at most five and whose
    block stays within 384 threads (802.11n 1944 r5/6, 802.16e r5/6 and
    r2/3A at z > 32); else 8 (wide).  By the code's shape alone; 0 for rows
    past 64."""
    width = lanes(code)
    if not width:
        return 0
    if code.max_row_degree <= _NARROW * width:
        return _NARROW
    if (mode_bits == 0 and not _xor(code) and group_slots(code) == 0
            and code.max_row_degree <= _FITTED * width
            and code.z * width * tile <= _FITTED_THREADS):
        return _FITTED
    return _WIDE


def _max_threads(code, mode_bits: int) -> int:
    """The block thread limit of the instantiation that serves ``code`` in
    ``mode_bits`` at one codeword a block; for the fitted one its own, so
    that every tile the wrapper picks runs it."""
    per_lane = edges_per_lane(code, mode_bits)
    if per_lane == _FITTED:
        return _FITTED_THREADS
    return _MAX_THREADS if per_lane == _NARROW else _MAX_THREADS // 2


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(code, device_index: int, mode_bits: int, itemsize: int) -> tuple:
    """The kernel library's occupancy query for ``code`` in ``mode_bits``
    with ``itemsize``-byte messages on CUDA device ``device_index``: blocks
    of 1, 2, ... codewords that one SM holds at once, up to the last tile
    that fits (empty if not even one codeword does).  It builds the kernel
    at first use."""
    lib = _build.load()
    width = lanes(code)
    out = []
    for tile in range(1, _max_threads(code, mode_bits) // max(1, code.z * width) + 1):
        blocks = lib.ldpc_bp_layered_blocks_per_sm(
            code.n, code.z, code.m_b, code.num_blocks, group_slots(code),
            code.max_row_degree, mode_bits, itemsize, int(_xor(code)), width, tile,
            device_index)
        if blocks < 0:
            raise RuntimeError(f"bp_layered occupancy query failed: CUDA error {-blocks}")
        if blocks == 0:
            break
        out.append(blocks)
    return tuple(out)


def tile_size(code, device_index: int, batch: int, mode_bits: int = 0,
              itemsize: int = 4) -> int:
    """Codewords per thread block for a launch of ``batch`` codewords on
    CUDA device ``device_index`` in mode ``mode_bits`` (:func:`mode`; 0 =
    layered min-sum) with ``itemsize``-byte messages (4 f32, 2 bf16):
    :func:`choose_tile` over the device's SMs and the kernel library's
    occupancy (0 if not even one codeword fits)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return choose_tile(batch, sms, _blocks_per_sm(code, device_index, mode_bits, itemsize))


def _route_b(code: QCCode, cfg: DecoderConfig | None) -> bool:
    """Kernel B's domain (``pallas_bp._build_kernel_dyn`` refuses the rest,
    ``pallas_bp.py:424-430,534-538``), on the cyclic codes without
    multi-edge cells that kernel C leaves (z below ``MIN_Z``), so auto
    dispatch keeps every code kernel C serves on it."""
    if code.z >= MIN_Z or code.extra_blocks:
        return False
    return cfg is None or (
        cfg.schedule == "layered" and cfg.algorithm == "min-sum"
        and not cfg.soft_output
        and isinstance(cfg.normalization, (int, float))
        and isinstance(cfg.offset, (int, float)))


def supported(code, cfg: DecoderConfig | None = None, device=None) -> bool:
    """True for an unmasked QC code (multi-edge cells allowed) or an
    RS-LDPC code (the xor group) and, when ``cfg`` is given, for the
    configurations the kernel serves, f32 or bf16 messages: with at most
    120 circulants (256 xor blocks) every schedule, algorithm and soft
    output (kernel A), with more only kernel B's layered min-sum on a
    cyclic code without multi-edge cells with z < 64.  A config with CRC
    or outer-code acceptance is refused (the kernel is syndrome-only;
    ``Decoder`` wraps it), and so is a per-iteration weight schedule.  When
    a CUDA ``device`` is given, the per-codeword state of the config's mode
    must also fit a thread block's shared memory there (:func:`tile_size`)."""
    if isinstance(code, RSLDPCCode):  # z = 2^s: r ^ s stays in [0, z)
        if code.num_blocks > _MAX_XOR_BLOCKS:
            return False
    elif not isinstance(code, QCCode) or code.masked_rows:
        return False
    elif code.num_blocks > _MAX_BLOCKS and not _route_b(code, cfg):
        return False
    mode_bits = 0 if cfg is None else mode(cfg)
    if not lanes(code) or code.z * lanes(code) > _max_threads(code, mode_bits):
        return False
    if cfg is not None and not (cfg.crc is None and cfg.outer is None):
        return False
    if cfg is not None and weights_mode(cfg, code.m_b) == "iter":
        return False  # the weight tables hold one row (pallas_bp.py:145-158)
    return device is None or len(_blocks_per_sm(
        code, cuda_index(device), mode_bits, msg_dtype(cfg).itemsize)) >= 1


def decode_qc_cuda_plain(code, cfg: DecoderConfig,
                         llr: torch.Tensor) -> DecodeResult:
    """The kernel's plain version: the torch decode of ops/bp.py (layered or
    flooding), whose JAX counterpart the reference pins bit-exact to the TPU
    kernels in f32 (sum-product to a tolerance); under bf16 it rounds after
    every operation, as the kernel does."""
    return decode_qc(code, cfg, llr)


def edge_words(code) -> np.ndarray:
    """The kernel's edge table, int64 [num_blocks]: each block's column's
    first variable (col * z) above its shift's 10 bits."""
    _, bc, sh = code.blocks
    return (bc.astype(np.int64) * code.z << _SHIFT_BITS) | sh


def column_edges(code) -> tuple[np.ndarray, np.ndarray]:
    """Per-column edge lists (CSC order): col_ptr [n_b + 1] and the
    column-list words [num_blocks], the blocks of block column j ascending
    at [col_ptr[j]:col_ptr[j + 1]] (the order in which the flooding rebuild
    adds R), each as block | layer << 9 | position within its row << 20
    (where the rebuild finds the block's message in a min-sum record)."""
    _, bc, _ = code.blocks
    ptr = np.asarray(code.layer_ptr)
    layer = np.repeat(np.arange(code.m_b), np.diff(ptr))
    pos = np.arange(code.num_blocks) - ptr[layer]
    col_edge = np.argsort(bc, kind="stable")
    col_ptr = np.searchsorted(bc[col_edge], np.arange(code.n_b + 1))
    words = (col_edge | (layer[col_edge] << _EDGE_BITS)
             | (pos[col_edge] << (_EDGE_BITS + _LAYER_BITS)))
    return col_ptr, words


def _device_tables(code: QCCode, normalization, offset, device: torch.device):
    """Code structure (edge words, layer pointers), per-column edge lists,
    the cell table and per-layer weights as device arrays (a plan's
    tables, so that a launch copies nothing from the host)."""
    alphas, betas = layer_weights(normalization, offset, code.m_b)
    col_ptr, col_edge = column_edges(code)
    return (*(dev(a, np.int32, device) for a in (edge_words(code), code.layer_ptr, col_ptr,
                                                  col_edge, cell_table(code))),
            dev(alphas, np.float32, device), dev(betas, np.float32, device))


def clocked(code, cfg: DecoderConfig) -> bool:
    """True where the kernel has a clocked instantiation: layered min-sum
    on a cyclic code without multi-edge cells (f32 or bf16)."""
    return mode(cfg) == 0 and not _xor(code) and group_slots(code) == 0


def slot_counter(device, stream: int) -> torch.Tensor:
    """The slot counter of ``device`` and ``stream`` (int64 [len(SLOT_CLOCKS)
    + 3]: zeros, then the scratch at its idle values, when made): made at
    its first use, then kept for the process.  Each stream has its own, so
    that launches in flight together never share a launch's scratch."""
    key = (torch.device(device), stream)
    counter = _slot_counters.get(key)
    if counter is None:
        counter = torch.tensor((0,) * len(SLOT_CLOCKS) + _SLOT_SCRATCH, dtype=torch.int64,
                               device=key[0])
        _slot_counters[key] = counter
    return counter


def slot_clocks() -> "dict | None":
    """What the slot counters hold, summed over the devices and streams:
    {slot of :data:`SLOT_CLOCKS`: int}; None while no counter exists.
    Reading waits for each device's queued work."""
    if not _slot_counters:
        return None
    total = sum(c[:len(SLOT_CLOCKS)].cpu() for c in _slot_counters.values())
    return dict(zip(SLOT_CLOCKS, total.tolist()))


def fold_slot_clocks(entry_ns, exit_ns, tile: int, executed, iterations,
                     slots: int, skips=None) -> dict:
    """What one clocked launch adds to the slot counter, from each block's
    entry and exit times (ns), the tile, each block's sweeps (``executed``),
    each codeword's iterations, the launch's slots and each block's sweeps
    whose syndrome pass it skipped (``skips``; None: none): the kernel's
    own fold (csrc/bp_layered.cu, ``add_slot_clocks``), on the host."""
    entry = np.asarray(entry_ns, dtype=np.int64)
    leave = np.asarray(exit_ns, dtype=np.int64)
    return {"resident_ns": int((leave - entry).sum()),
            "slot_ns": int(slots) * int(leave.max() - entry.min()),
            "frame_sweeps": int(np.asarray(iterations, dtype=np.int64).sum()),
            "block_sweeps": int(np.asarray(executed, dtype=np.int64).sum()) * int(tile),
            "blocks": int(entry.size), "launches": 1,
            "syndrome_skips": 0 if skips is None
            else int(np.asarray(skips, dtype=np.int64).sum()) * int(tile)}


@dataclasses.dataclass(frozen=True, eq=False)
class Plan(cuda_launch.Plan):
    """Kernel A's launches (:func:`plan`): ``ldpc_bp_layered``'s integers
    between the batch and the tile (``shape``) and after it (``flags``), and
    whether a launch may run clocked (:func:`clocked`)."""

    kind, entry = "short", "ldpc_bp_layered"
    device_tables = staticmethod(_device_tables)

    shape: tuple
    flags: tuple
    clockable: bool

    def args(self, outs, llr_k, tile, stream) -> tuple:
        """Last come the slot counter while a profiler records a clockable
        launch (else None) and the launch's slots (else 0)."""
        clock = recording() and self.clockable
        return (*outs, *(t.data_ptr() for t in self.tables), llr_k.shape[0], *self.shape, tile,
                *self.flags, stream,
                slot_counter(llr_k.device, stream).data_ptr() if clock else None,
                self.sms * self.occupancy[tile - 1] if clock else 0)


def plan(code, cfg: DecoderConfig, device) -> Plan:
    """Kernel A's plan for ``code`` under ``cfg`` on CUDA ``device`` (the
    current device where it names none), made once: the occupancy
    (:func:`_blocks_per_sm`), the device's SMs and the tiles the fitted
    instantiation serves (:func:`edges_per_lane`); ValueError where
    :func:`supported` refuses it."""
    return _plan(code, cfg, indexed(device))


@functools.lru_cache(maxsize=64)
def _plan(code, cfg: DecoderConfig, device: torch.device) -> Plan:
    if not supported(code, cfg, device):
        raise ValueError(
            f"the CUDA short-code kernel does not serve {code.name} under "
            f"this config: it needs {REQUIREMENTS}")
    mode_bits = mode(cfg)
    bf16 = cfg.msg_dtype == "bfloat16"
    index = cuda_index(device)
    occupancy = _blocks_per_sm(code, index, mode_bits, msg_dtype(cfg).itemsize)
    counts = tuple(name for name, on in (
        ("launches", True), ("soft_launches", cfg.soft_output), ("bf16_launches", bf16),
        ("xor_launches", _xor(code)), ("multi_edge_launches", group_slots(code) > 0)) if on)
    return Plan(code, cfg, device, decode_qc_cuda, counts,
                (code.n_b, code.z, code.m_b, code.num_blocks, group_slots(code),
                 code.max_row_degree, lanes(code)),
                (cfg.max_iters, int(cfg.early_exit), mode_bits, int(bf16), int(_xor(code))),
                clocked(code, cfg),
                sms=torch.cuda.get_device_properties(index).multi_processor_count,
                occupancy=occupancy,
                fitted=frozenset(t for t in range(1, len(occupancy) + 1)
                                 if edges_per_lane(code, mode_bits, t) == _FITTED))


def decode_qc_cuda(code, cfg: DecoderConfig,
                   llr: torch.Tensor) -> DecodeResult:
    """Decode [B, n] float32 LLRs (positive => bit 0) with the kernel in
    ``cfg``'s mode.  Returns the same DecodeResult as ops/bp.py, posteriors
    included (in the message dtype) with ``cfg.soft_output``; ``total_iters``
    is the largest sweep count of any thread block, the batch's loop count
    of the single-loop torch path."""
    if cuda_launch.check_llr(code, llr):
        return decode_qc_cuda_plain(code, cfg, llr)
    return cuda_launch.decode("short", lambda: plan(code, cfg, cuda_launch.card(llr)), llr)


def _prepare(code, cfg: DecoderConfig, llr: torch.Tensor, tile: int):
    """(result, ``ldpc_bp_layered``'s arguments) of a launch, ``tile`` a block."""
    return cuda_launch.prepare(plan(code, cfg, llr.device), llr, tile)


decode_qc_cuda.launches = 0
decode_qc_cuda.soft_launches = 0
decode_qc_cuda.bf16_launches = 0
decode_qc_cuda.xor_launches = 0
decode_qc_cuda.multi_edge_launches = 0
decode_qc_cuda.fitted_launches = 0
