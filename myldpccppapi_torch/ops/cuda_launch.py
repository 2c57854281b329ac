"""The host launch path that kernel A (``ops/cuda_bp.py``) and kernels C
and D (``ops/cuda_long.py``, ``ops/cuda_stream.py``) share.

Each kernel module resolves a :class:`Plan` once per (code, config,
device) and caches it (``cuda_bp.plan``, ``cuda_long.plan``); ``Decoder``
holds its plan (:func:`launch`), and ``decode_qc_cuda`` and
``decode_qc_long`` look theirs up.  :func:`decode` is the one launch
sequence: the plan (for a public call, with the device checks), the tile,
the outputs, the cast and the argument list inside the span
``myldpc.<kind>.prepare`` (:func:`prepare`), the library call inside ``myldpc.<kind>.launch``, then
the launch counters and ``executed.max()`` inside ``myldpc.<kind>.finish``
(:func:`run`); ``kind`` is ``short`` for kernel A, ``long`` for C and D.
Here too are the code facts that more than one kernel reads, each cached
per code.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.config import DecoderConfig
from ..utils.profiling import span
from . import _build
from .bp import DecodeResult, msg_dtype

__all__ = ["HAS_MASK", "MIN_Z", "MULTI_EDGE", "Plan", "card", "check_llr", "choose_tile",
           "decode", "dev", "group_slots", "launch", "layer_flags", "live_rows", "live_words",
           "mask_slots", "n_masks", "prepare", "run"]

#: the reference kernel's gate (pallas_zlane.zlane_supported): below half a
#: 128-lane tile the TPU layout wastes the VPU, and small-z codes go to the
#: short-code kernels there (kernel C serves z >= MIN_Z, kernel B's route
#: of ops/cuda_bp.py the cyclic codes below it)
MIN_Z = 64
#: layer flag bits, as both long-code kernels read them
MULTI_EDGE, HAS_MASK = 1, 2


@functools.lru_cache(maxsize=64)
def group_slots(code) -> int:
    """The most circulants of multi-edge cells (blocks of one layer that
    share a block column) in any one layer: the rows of the kernels'
    layered delta tables (0 without such cells)."""
    _, bc, _ = code.blocks
    ptr = code.layer_ptr
    most = 0
    for i in range(code.m_b):
        _, counts = np.unique(bc[ptr[i]:ptr[i + 1]], return_counts=True)
        most = max(most, int(counts[counts > 1].sum()))
    return most


@functools.lru_cache(maxsize=64)
def n_masks(code) -> int:
    """Blocks of ``code`` with row-masked (partial) circulants."""
    return sum(m is not None for m in code.block_row_masks)


@functools.lru_cache(maxsize=64)
def layer_flags(code) -> np.ndarray:
    """[m_b] int32: MULTI_EDGE where two circulants share a (layer, column)
    cell (they are adjacent in block order, QCCode.blocks), HAS_MASK where
    the layer has a row-masked block."""
    _, bc, _ = code.blocks
    masks = code.block_row_masks
    ptr = code.layer_ptr
    flags = np.zeros(code.m_b, dtype=np.int32)
    for i in range(code.m_b):
        cols = bc[ptr[i]:ptr[i + 1]]
        if len(np.unique(cols)) < len(cols):
            flags[i] |= MULTI_EDGE
        if any(masks[e] is not None for e in range(ptr[i], ptr[i + 1])):
            flags[i] |= HAS_MASK
    return flags


def live_words(mask: np.ndarray, words: int) -> np.ndarray:
    """bool[z] live rows -> [words] int32 bit words (bit r of word w is row
    32 w + r), as both long-code kernels read them."""
    bits = np.zeros(words * 32, dtype=bool)
    bits[:len(mask)] = mask
    return np.packbits(bits, bitorder="little").view("<u4").view(np.int32)


@functools.lru_cache(maxsize=64)
def live_rows(code) -> np.ndarray:
    """The masked blocks' :func:`live_words`, in block order (one zero word
    without a masked block): the long-code kernels' live-row table."""
    words = (code.z + 31) // 32
    live = [live_words(m, words) for m in code.block_row_masks if m is not None]
    return np.concatenate(live) if live else np.zeros(1, np.int32)


def mask_slots(code) -> np.ndarray:
    """[num_blocks] int64: a masked block's slot in :func:`live_rows`,
    counted from 1; 0 for a whole circulant."""
    masked = np.array([m is not None for m in code.block_row_masks], dtype=np.int64)
    return np.cumsum(masked) * masked


def dev(a, dtype, device) -> torch.Tensor:
    """Host table ``a`` as a ``dtype`` (numpy) tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """What every launch of one kernel on ``code`` under ``cfg`` on
    ``device`` (naming its index) shares: ``counts``, the attributes of the
    decode function ``counter`` that a launch bumps; for kernel A the SMs,
    the occupancy (blocks of 1, 2, ... codewords an SM; C and D run one a
    block) and the tiles that ``fitted_launches`` counts too.  A kernel's
    subclass names its span prefix (``kind``), launcher (``entry``) and
    tables (``device_tables``, made at the first launch), and builds the
    launcher's arguments, ``args(outs, llr_k, tile, stream)``: ``outs`` are
    the pointers of ``llr_k`` (the LLRs in the message dtype) and of the
    outputs, the first six."""

    code: object
    cfg: DecoderConfig
    device: torch.device
    counter: object
    counts: tuple
    _: dataclasses.KW_ONLY
    sms: int = 0
    occupancy: tuple = ()
    fitted: frozenset = frozenset()

    @functools.cached_property
    def tables(self) -> tuple:
        return self.device_tables(self.code, self.cfg.normalization, self.cfg.offset,
                                  self.device)


def choose_tile(batch: int, sms: int, blocks_per_sm) -> int:
    """Codewords per thread block for ``batch`` codewords on ``sms`` SMs,
    where ``blocks_per_sm[t - 1]`` blocks of ``t`` codewords fit on one SM
    at once: the smallest tile at which the whole batch is resident at once
    (``sms * blocks * tile >= batch``), so that it spreads over every SM in
    the smallest blocks; else the tile that holds the most codewords at once
    (the smallest of equals).  0 if not even one codeword fits."""
    best, most = 0, 0
    for tile, blocks in enumerate(blocks_per_sm, start=1):
        resident = sms * blocks * tile
        if resident >= batch:
            return tile
        if resident > most:
            best, most = tile, resident
    return best


def check_llr(code, llr: torch.Tensor) -> bool:
    """Check ``llr``'s shape and dtype for a kernel's decode of ``code``
    (ValueError unless [B, n] float32): True for a CPU tensor, where the
    kernel's plain version decodes."""
    if llr.ndim != 2 or llr.shape[1] != code.n:
        raise ValueError(f"expected llr of shape [batch, {code.n}], got {tuple(llr.shape)}")
    if llr.dtype != torch.float32:
        raise ValueError(f"expected float32 llr, got {llr.dtype}")
    return llr.device.type == "cpu"


def card(llr: torch.Tensor) -> torch.device:
    """``llr``'s device; ValueError unless a contiguous CUDA tensor."""
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    return llr.device


def prepare(plan: Plan, llr: torch.Tensor, tile: int):
    """A launch of ``plan`` on a checked CUDA ``llr``, ``tile`` codewords a
    block: (result, args), its outputs with each block's sweep count
    (``executed``) as ``total_iters``, and the launcher's arguments; args
    None for an empty batch, whose result is final."""
    code, cfg = plan.code, plan.cfg
    batch, device = llr.shape[0], llr.device
    dt = msg_dtype(cfg)
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=device)
    conv = torch.empty((batch,), dtype=torch.bool, device=device)
    iters = torch.empty((batch,), dtype=torch.int32, device=device)
    post = torch.empty((batch, code.n), dtype=dt, device=device) if cfg.soft_output else None
    if batch == 0:
        return DecodeResult(bits, conv, iters, torch.zeros((), dtype=torch.int32, device=device),
                            posteriors=post), None
    executed = torch.empty((-(-batch // tile),), dtype=torch.int32, device=device)
    llr_k = llr.to(dt)  # bf16: cast on the card (the reference casts first)
    outs = (llr_k.data_ptr(), bits.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            executed.data_ptr(), None if post is None else post.data_ptr())
    return (DecodeResult(bits, conv, iters, executed, posteriors=post),
            plan.args(outs, llr_k, tile, torch.cuda.current_stream(device).cuda_stream))


def run(plan: Plan, result: DecodeResult, args, tile: int) -> DecodeResult:
    """Make :func:`prepare`'s library call (none for an empty batch),
    then count it and return its result with ``total_iters`` the largest
    block sweep count; raises if the launch fails."""
    if args is None:
        return result
    with torch.cuda.device(result.bits.device):
        with span(plan.kind + ".launch"):
            err = getattr(_build.load(), plan.entry)(*args)
    if err != 0:
        raise RuntimeError(f"{plan.entry.removeprefix('ldpc_')} kernel launch failed: "
                           f"CUDA error {err}")
    with span(plan.kind + ".finish"):
        for name in plan.counts + (("fitted_launches",) if tile in plan.fitted else ()):
            setattr(plan.counter, name, getattr(plan.counter, name) + 1)
        return DecodeResult(result.bits, result.converged, result.iterations,
                            result.total_iters.max(), posteriors=result.posteriors)


def decode(kind: str, lookup, llr: torch.Tensor, tile: int = 0) -> DecodeResult:
    """Decode ``llr`` (shape and dtype checked, not on the CPU) with the
    plan ``lookup()`` of a ``kind`` kernel, in its tile for the batch or in
    ``tile`` (any tile that fits gives the same result).  A public decode
    function's lookup checks the device (:func:`card`) and finds its plan
    inside ``myldpc.<kind>.prepare``."""
    with span(kind + ".prepare"):
        plan = lookup()
        tile = tile or (choose_tile(llr.shape[0], plan.sms, plan.occupancy)
                        if plan.occupancy else 1)
        result, args = prepare(plan, llr, tile)
    return run(plan, result, args, tile)


def launch(plan: Plan, llr: torch.Tensor, tile: int = 0) -> DecodeResult:
    """:func:`decode` with ``plan``, which a ``Decoder`` resolved."""
    return decode(plan.kind, lambda: plan, llr, tile)
